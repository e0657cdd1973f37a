"""Plain PyTorch versions of every kernel (the allclose targets).

The wrappers in ``kernels.ops`` run these for CPU tensors; on the card
``chip_smoke.py`` holds each kernel against them on the same inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def softcap_ref(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def gemm_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None, acc=None
             ) -> torch.Tensor:
    """x (M, K) @ w (K, N) in float32 (added to ``acc``, float32, when
    given), cast to ``out_dtype`` (x's by default)."""
    y = x.float() @ w.float()
    if acc is not None:
        y = acc + y
    return y.to(out_dtype or x.dtype)


def block_attention_ref(q, k, v, q_pos, kv_pos, kv_mask, *, scale: float,
                        softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Bidirectional GQA attention with arbitrary KV validity mask.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); q_pos: (B, Sq) int;
    kv_pos: (B, Skv) int; kv_mask: (B, Skv) bool. Returns (B, Sq, H, D)
    float32; query rows with no valid key are exact zeros.
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = (q.float() * scale).reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if softcap:
        scores = softcap_ref(scores, softcap)
    mask = kv_mask[:, None, :].expand(B, Sq, Skv)
    if window:
        dist = (q_pos[:, :, None].long() - kv_pos[:, None, :].long()).abs()
        mask = mask & (dist <= window)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked query rows emit exactly zero (kernel semantics), not
    # the uniform average that softmax over a -1e30 row would give
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    probs = torch.where(any_valid, probs, torch.zeros_like(probs))
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, D)


def confidence_argmax_ref(logits: torch.Tensor, mask_id: int = -1):
    """logits: (N, V) -> (conf (N,) f32, idx (N,) int32), in float32.

    Column ``mask_id`` (if >= 0) is banned: set to -1e30 after the cast.
    conf = max softmax prob = exp(max - logsumexp); idx is the first
    index of the max."""
    x = logits.float()
    if mask_id >= 0:
        x = x.clone()
        x[..., mask_id] = NEG_INF
    m = x.max(dim=-1).values
    conf = torch.exp(m - torch.logsumexp(x, dim=-1))
    idx = torch.argmax(x, dim=-1).to(torch.int32)
    return conf, idx


# ---------------------------------------------------------------- scans
# The recurrent mixers' time scans (``models.recurrent``), as the JAX
# package computes them (``src/repro/models/recurrent.py``). ``acc`` is
# the state and gate dtype: float32, as the reference keeps it, or
# float64 for a run that measures the float32 version's own rounding.

def linear_scan(a, b, h0, *, assoc: bool = True):
    """h_t = a_t * h_{t-1} + b_t along axis 1; a, b (B, S, w), h0 (B, w).
    Returns (hs (B, S, w), h_S). ``assoc`` is the reference's associative
    form (h0 folded into b_0, then a log-depth scan of the pairs), else
    the sequential one."""
    if not assoc:
        h, hs = h0, []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        return torch.stack(hs, dim=1), h
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, off = a.shape[1], 1
    while off < S:
        # (a, b)_t <- (a, b)_{t-off} o (a, b)_t for t >= off
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b, b[:, -1]


def rglru_gates(gx, u, lam, acc=torch.float32):
    """RG-LRU's recurrence coefficients: gx (B, S, 2w) = u @ [w_a | w_x]
    in float32, u (B, S, w), lam (w,) -> (a, b), each (B, S, w)."""
    w = u.shape[-1]
    uf = u.to(acc)
    r = torch.sigmoid(gx[..., :w].to(acc))
    i = torch.sigmoid(gx[..., w:].to(acc))
    log_a = -8.0 * torch.nn.functional.softplus(lam.to(acc)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def rglru_scan_ref(gx, u, lam, h0, *, assoc: bool = True,
                   acc=torch.float32):
    """The RG-LRU scan: gates from ``rglru_gates``, then h_t = a_t h_{t-1}
    + b_t. Returns (hs (B, S, w), h_S (B, w)) in ``acc``."""
    a, b = rglru_gates(gx, u, lam, acc)
    return linear_scan(a, b, h0.to(acc), assoc=assoc)


def mlstm_split(proj, H: int, dk: int, dv: int, acc=torch.float32):
    """The mLSTM's fused projection (B, S, N) = c @ [wq | wk | wv | w_i |
    w_f | zero pad] -> q, k / sqrt(dk) (B, S, H, dk), v (B, S, H, dv),
    i, f (B, S, H), all in ``acc``."""
    B, S = proj.shape[:2]
    o = [0, H * dk, 2 * H * dk, 2 * H * dk + H * dv,
         2 * H * dk + H * dv + H, 2 * H * dk + H * dv + 2 * H]
    q = proj[..., o[0]:o[1]].to(acc).reshape(B, S, H, dk)
    k = proj[..., o[1]:o[2]].to(acc).reshape(B, S, H, dk) / math.sqrt(dk)
    v = proj[..., o[2]:o[3]].to(acc).reshape(B, S, H, dv)
    return q, k, v, proj[..., o[3]:o[4]].to(acc), proj[..., o[4]:o[5]].to(acc)


def mlstm_scan_ref(proj, C, n, m, *, H: int, dk: int, dv: int,
                   acc=torch.float32):
    """The mLSTM's stabilised matrix-memory scan over the fused
    projection (``mlstm_split``) from state (C (B, H, dk, dv), n (B, H,
    dk), m (B, H)). Returns (hs (B, S, H * dv), C, n, m) in ``acc``."""
    q, k, v, it, ft = mlstm_split(proj, H, dk, dv, acc)
    C, n, m = C.to(acc), n.to(acc), m.to(acc)
    hs = []
    for t in range(proj.shape[1]):
        f_log = torch.nn.functional.logsigmoid(ft[:, t])       # (B, H)
        m_new = torch.maximum(f_log + m, it[:, t])
        i_p = torch.exp(it[:, t] - m_new)
        f_p = torch.exp(f_log + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * (
            k[:, t, :, :, None] * v[:, t, :, None, :])
        n = f_p[..., None] * n + i_p[..., None] * k[:, t]
        num = torch.einsum("bhkv,bhk->bhv", C, q[:, t])
        den = torch.abs(torch.einsum("bhk,bhk->bh", n, q[:, t]))
        hs.append(num / torch.clamp(den, min=1.0)[..., None])
        m = m_new
    B, S = proj.shape[:2]
    return torch.stack(hs, dim=1).reshape(B, S, H * dv), C, n, m


def slstm_scan_ref(pre, r, h, c, n, m, *, acc=torch.float32):
    """The sLSTM's scan: pre (B, S, 4 d) = x @ [w_z | w_i | w_f | w_o],
    r (4, H, hd, hd) the block-diagonal recurrent matrices of the four
    gates, state h, c, n, m (B, d). Returns (hs (B, S, d), h, c, n, m) in
    ``acc``."""
    B, S = pre.shape[:2]
    _, H, hd, _ = r.shape
    d = H * hd
    pre = pre.to(acc).reshape(B, S, 4, d)
    r = r.to(acc)
    h, c, n, m = (t.to(acc) for t in (h, c, n, m))

    def rmat(hprev, g):
        return torch.einsum("bhk,hkj->bhj", hprev.reshape(B, H, hd),
                            r[g]).reshape(B, d)

    hs = []
    for t in range(S):
        zt = torch.tanh(pre[:, t, 0] + rmat(h, 0))
        it = pre[:, t, 1] + rmat(h, 1)
        ft = torch.nn.functional.logsigmoid(pre[:, t, 2] + rmat(h, 2))
        ot = torch.sigmoid(pre[:, t, 3] + rmat(h, 3))
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * (c / torch.clamp(n, min=1.0))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), h, c, n, m
