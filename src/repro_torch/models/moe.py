"""Mixture-of-Experts FFN, dense path: the PyTorch counterpart of
``repro.models.moe``'s ``init_moe``, ``_route``, ``_balance_stats``,
``load_balance_loss``, ``_expert_ffn`` and ``apply_moe_dense``.

Every expert runs for every token and the top-k gates combine them, as
the reference's dense path does; a sparse dispatch is the
expert-parallel path (ROADMAP A11). Params: ``router (d, E)``, kept in
float32 whatever the model's dtype (as the JAX package keeps it),
``w_gate``/``w_up (E, d, f)`` and ``w_down (E, f, d)``.

On the card every product goes through ``ops.linear`` (the GEMM kernel,
whose sum order does not depend on the row count): the float32 router
product and each expert's gate, up and down, one launch each, so
``1 + 3 E`` launches a layer. The rest keeps a row's bits independent of
the batch it sits in, and reads nothing back to the host (a captured
block keeps its one sync): the top-k is a stable descending sort (on
equal probabilities the lower expert first, as ``jax.lax.top_k``), the
gate sum runs over k in order, and the combine adds the experts in a
fixed order (e = 0, 1, ...) in float32 with one elementwise op an
expert (``addcmul``, which widens the expert's output as it reads it).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import linear
from repro_torch.models.layers import dense_init


def _stacked_init(generator: torch.Generator, shape, in_axis_size: int,
                  dtype) -> torch.Tensor:
    """``dense_init`` of an (E, ...) stack drawn one expert at a time, so
    the float32 draw never holds more than one expert (kimi-k2's
    (384, 7168, 2048) would take 22.5 GB at once)."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for e in range(shape[0]):
        out[e] = dense_init(generator, shape[1:], in_axis_size, dtype)
    return out


def init_moe(generator: torch.Generator, cfg, dtype) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": dense_init(generator, (d, E), d, torch.float32),
        "w_gate": _stacked_init(generator, (E, d, f), d, dtype),
        "w_up": _stacked_init(generator, (E, d, f), d, dtype),
        "w_down": _stacked_init(generator, (E, f, d), f, dtype),
    }


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first, ties to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, p, x2d, train: bool = False):
    """x2d: (T, d) -> (probs (T, E) f32, top-k weights (T, k) f32
    renormalised, top-k ids (T, k))."""
    logits = linear(x2d.float(), p["router"], train=train)
    probs = torch.softmax(logits, dim=-1)
    w, ids = top_k(probs, cfg.moe_top_k)
    total = w[:, 0]
    for j in range(1, w.shape[1]):
        total = total + w[:, j]
    return probs, w / torch.clamp_min(total, 1e-9)[:, None], ids


def balance_stats(cfg, probs, ids) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f_e, the share of top-k assignments per expert; P_e, the mean
    router probability per expert), each (E,)."""
    experts = torch.arange(cfg.n_experts, device=ids.device)
    onehot = (ids[..., None] == experts).float()             # (T, k, E)
    return onehot.mean(dim=(0, 1)), probs.mean(dim=0)


def load_balance_loss(cfg, probs, ids) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (1 when uniform)."""
    f, pm = balance_stats(cfg, probs, ids)
    return cfg.n_experts * torch.sum(f * pm)


def expert_ffn(x2d, wg, wu, wd, train: bool = False):
    """One expert's SwiGLU on x2d (T, d): (T, d) in x2d's dtype."""
    h = F.silu(linear(x2d, wg, train=train)) * linear(x2d, wu, train=train)
    return linear(h, wd, train=train)


def apply_moe_dense(cfg, p, x, train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss () f32)."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    probs, w, ids = route(cfg, p, x2, train=train)
    comb = torch.zeros_like(probs).scatter(1, ids, w)        # (T, E)
    y = torch.zeros(x2.shape, dtype=torch.float32, device=x.device)
    # unbind: one view per expert, whose backward stacks the gradients once
    experts = zip(*(p[k].unbind(0) for k in ("w_gate", "w_up", "w_down")))
    for e, (wg, wu, wd) in enumerate(experts):
        ye = expert_ffn(x2, wg, wu, wd, train=train)
        y = torch.addcmul(y, ye, comb[:, e:e + 1])        # y + ye * comb_e
    return y.reshape(B, S, d).to(x.dtype), load_balance_loss(cfg, probs, ids)
