"""Temporal component of Streaming-dLLM: confidence scores, the dynamic
threshold (Eq. 10), and the token selection rule S(.) (Eq. 9) — the
PyTorch counterpart of ``repro.core.schedule``.

All functions run on device tensors (no host sync) and operate on the
*current block* region.
"""
from __future__ import annotations

from typing import Tuple

import torch


def confidence_and_tokens(logits: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 4: c_i = max softmax(z_i); x_hat_i = argmax softmax(z_i).

    logits: (..., V) float32 -> (conf (...,), tokens (...,) int32), via
    logsumexp (the softmax is never materialized). The argmax takes the
    first index of the max."""
    m = logits.max(dim=-1).values
    conf = torch.exp(m - torch.logsumexp(logits, dim=-1))
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    return conf, toks


def chunked_head_reduce(hidden: torch.Tensor, head: torch.Tensor, reduce_fn,
                        *, row_chunk: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project row chunks of the final hidden states through the LM head
    (in the hidden dtype) and hand each chunk's 2-D logits, as the
    product gives them, to ``reduce_fn`` -> (conf, tok), so the full
    ``(..., V)`` logits never exist as one array. Shared by the plain
    reducer below and the kernel route in ``kernels.ops``.

    hidden: (..., d); head: (d, V).
    """
    shape = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    confs, toks = [], []
    for s in range(0, h2.shape[0], row_chunk):
        hc = h2[s:s + row_chunk]
        c, t = reduce_fn(hc @ head.to(hc.dtype))
        confs.append(c)
        toks.append(t)
    conf = confs[0] if len(confs) == 1 else torch.cat(confs)
    tok = toks[0] if len(toks) == 1 else torch.cat(toks)
    return conf.reshape(shape), tok.reshape(shape)


def head_confidence_and_tokens(hidden: torch.Tensor, head: torch.Tensor, *,
                               mask_id: int = -1, logit_softcap: float = 0.0,
                               row_chunk: int = 1024
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-head path with the plain reducer: each chunk's logits in
    float32, softcapped, [MASK] banned, then Eq. 4. Row chunking leaves
    each row's reduction untouched, so per-row results match
    ``confidence_and_tokens`` over the monolithic logits."""

    def reduce(logits):
        logits = logits.float()
        if logit_softcap:
            logits = logit_softcap * torch.tanh(logits / logit_softcap)
        if mask_id >= 0:
            logits[:, mask_id] = -1e30
        return confidence_and_tokens(logits)

    return chunked_head_reduce(hidden, head, reduce, row_chunk=row_chunk)


def dynamic_threshold(tau0: float, alpha: float, r_mask: torch.Tensor
                      ) -> torch.Tensor:
    """Eq. 10: tau(t) = tau0 * (1 - alpha * (1 - r_mask)), in float32.

    r_mask in [0, 1]: fraction of still-masked tokens in the current
    block. Early (r_mask ~ 1) -> tau ~ tau0 (strict); late -> relaxed.
    """
    r_mask = r_mask.float()
    return tau0 * (1.0 - alpha * (1.0 - r_mask))


def select_tokens(conf: torch.Tensor, is_masked: torch.Tensor,
                  tau) -> torch.Tensor:
    """Eq. 9 selection rule. conf/is_masked: (B, K); tau: scalar or (B,).

    Returns commit mask (B, K): masked positions with conf >= tau; if a
    row has none, its single most-confident masked position (the first
    one on ties; guarantees progress). Rows with no masked positions
    commit nothing.
    """
    B, K = conf.shape
    tau = torch.as_tensor(tau, dtype=conf.dtype, device=conf.device)
    tau = tau.expand(B)
    mconf = torch.where(is_masked, conf, torch.full_like(conf, -torch.inf))
    above = is_masked & (conf >= tau[:, None])
    any_above = above.any(dim=1)
    any_masked = is_masked.any(dim=1)
    best = torch.argmax(mconf, dim=1)
    fallback = torch.nn.functional.one_hot(best, K).bool()
    fallback = fallback & (any_masked & ~any_above)[:, None]
    return above | fallback


def fixed_rate_select(conf: torch.Tensor, is_masked: torch.Tensor,
                      n_commit: int) -> torch.Tensor:
    """Vanilla baseline schedule: commit the n_commit most-confident
    masked tokens per step. Ties go to the lower index, as
    ``jax.lax.top_k`` orders them (a stable descending sort; the order
    of ``torch.topk`` on ties is unspecified)."""
    mconf = torch.where(is_masked, conf, torch.full_like(conf, -torch.inf))
    k = min(n_commit, conf.shape[1])
    idx = torch.sort(mconf, dim=1, descending=True, stable=True).indices[:, :k]
    commit = torch.zeros_like(is_masked)
    commit.scatter_(1, idx, True)
    return commit & is_masked
