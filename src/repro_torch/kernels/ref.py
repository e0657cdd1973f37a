"""Plain PyTorch versions of every kernel (the allclose targets).

The wrappers in ``kernels.ops`` run these for CPU tensors; on the card
``chip_smoke.py`` holds each kernel against them on the same inputs.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def softcap_ref(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


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
