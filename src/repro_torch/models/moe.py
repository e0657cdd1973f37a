"""Mixture-of-Experts FFN, dense path: the PyTorch counterpart of
``repro.models.moe``'s ``init_moe``, ``_route``, ``_balance_stats``,
``load_balance_loss``, ``_expert_ffn`` and ``apply_moe_dense``.

Every expert runs for every token and the top-k gates combine them, as
the reference's dense path does. Across ranks (a ``launch.mesh.Mesh``
with a data extent above one) the experts shard over ``data`` and the
tokens travel to their experts' ranks by ``all_to_all`` over the data
line (``apply_moe_ep``), or, with no data axes, every rank runs its own
experts for every token and a sum over the mesh combines them
(``apply_moe_ep_replicated``); each expert's hidden width shards over
``model`` (the products' partial sums complete over the model line).
``apply_moe`` picks the path as the reference's does. Params: ``router (d, E)``, kept in
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

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.cost import shape_only
from repro_torch.kernels.ops import linear
from repro_torch.models.layers import dense_init, row_parallel


def _stacked_init(generator: torch.Generator, shape, in_axis_size: int,
                  dtype) -> torch.Tensor:
    """``dense_init`` of an (E, ...) stack drawn one expert at a time, so
    the float32 draw never holds more than one expert (kimi-k2's
    (384, 7168, 2048) would take 22.5 GB at once). A shape-only stack
    (``launch.steps`` builds the params as fake tensors) draws nothing."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if shape_only(out):
        return out
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


def expert_ffn(x2d, wg, wu, wd, train: bool = False, out_dtype=None):
    """One expert's SwiGLU on x2d (T, d): (T, d) in x2d's dtype (or
    ``out_dtype`` float32: a partial sum over a sharded hidden width,
    left unrounded until the ranks' sum)."""
    h = F.silu(linear(x2d, wg, train=train)) * linear(x2d, wu, train=train)
    return linear(h, wd, train=train, out_dtype=out_dtype)


def _hidden_tp(cfg, p, tp):
    """``tp`` when the experts' hidden width is this rank's shard of it
    (``moe_d_ff`` split over the model line), else None."""
    return tp if (tp is not None
                  and p["w_gate"].shape[2] < cfg.moe_d_ff) else None


def apply_moe_dense(cfg, p, x, train: bool = False, tp=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss () f32).
    ``tp``: the model line, whose sum completes the experts' partial
    outputs where their hidden width is sharded."""
    tp = _hidden_tp(cfg, p, tp)
    part = torch.float32 if tp is not None else None
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    probs, w, ids = route(cfg, p, x2, train=train)
    comb = torch.zeros_like(probs).scatter(1, ids, w)        # (T, E)
    y = torch.zeros(x2.shape, dtype=torch.float32, device=x.device)
    # unbind: one view per expert, whose backward stacks the gradients once
    experts = zip(*(p[k].unbind(0) for k in ("w_gate", "w_up", "w_down")))
    for e, (wg, wu, wd) in enumerate(experts):
        ye = expert_ffn(x2, wg, wu, wd, train=train, out_dtype=part)
        y = torch.addcmul(y, ye, comb[:, e:e + 1])        # y + ye * comb_e
    if tp is not None:
        y = tp.all_reduce(y)
    return y.reshape(B, S, d).to(x.dtype), load_balance_loss(cfg, probs, ids)


# ------------------------------------------------------------- ranks

def rank_within(keys: torch.Tensor, n_groups: int) -> torch.Tensor:
    """For int keys (A,), the rank of each element among equal keys
    (stable: in index order)."""
    A = keys.shape[0]
    keys = keys.long()
    order = torch.sort(keys, stable=True).indices
    sorted_keys = keys[order]
    starts = torch.searchsorted(
        sorted_keys, torch.arange(n_groups, device=keys.device))
    rank_sorted = torch.arange(A, device=keys.device) - starts[sorted_keys]
    out = torch.empty((A,), dtype=torch.long, device=keys.device)
    out[order] = rank_sorted
    return out


# ------------------------------------------------------------- EP path

def _moe_local(cfg, p, x, data, model, two_d: bool):
    """One rank's part of ``apply_moe_ep`` (``src/repro/models/moe.py:
    _moe_local``). x: (T, d) this rank's tokens. ``data``/``model`` are
    its mesh lines (``launch.mesh.AxisGroup``); the experts are its
    (E_loc, ...) shard. Returns (y (T, d), f_e, p_e, dropped count).

    Two dispatch layouts: 1D (default) sends full-d activations over
    ``data``, experts (E_loc, d, f_loc) with f over ``model``, and the
    model sum runs after the return ``all_to_all`` and the combine, on
    the (T, d) outputs; 2D (``cfg.moe_2d_dispatch``) sends each model
    rank's d/n_model slice, experts (E_loc, d_loc, f), one f-sized sum
    over ``model`` before the nonlinearity, and the (T, d_loc) outputs
    gathered over ``model``.

    Every expert product goes through ``ops.linear``. The combine adds a
    token's k contributions in order (no atomics), so a row's bits do
    not depend on the launch."""
    T, d = x.shape
    k = cfg.moe_top_k
    E_loc = p["w_gate"].shape[0]
    n_shards = data.size
    probs, w, ids = route(cfg, p, x)
    dev = x.device

    # -------- dispatch
    A = T * k
    tok = torch.arange(T, device=dev).repeat_interleave(k)       # (A,)
    eid = ids.reshape(A).long()
    wgt = w.reshape(A)
    dest = eid // E_loc                                          # owning rank
    C = max(1, int(math.ceil(A / n_shards * cfg.moe_capacity_factor)))
    rank = rank_within(dest, n_shards)
    valid = rank < C
    slot = torch.where(valid, dest * C + rank,
                       torch.full_like(rank, n_shards * C))     # drop slot
    if two_d:
        d_loc = d // model.size
        x_send = x[:, model.index * d_loc:(model.index + 1) * d_loc]
    else:
        d_loc = d
        x_send = x
    buf = x.new_zeros((n_shards * C + 1, d_loc))
    buf[slot] = x_send[tok]
    ebuf = torch.full((n_shards * C + 1,), E_loc, dtype=torch.int32,
                      device=dev)
    ebuf[slot] = (eid % E_loc).to(torch.int32)
    vbuf = torch.zeros((n_shards * C + 1,), dtype=torch.int32, device=dev)
    vbuf[slot] = valid.to(torch.int32)
    recv = data.all_to_all(buf[:-1].reshape(n_shards, C, d_loc))
    recv_e = data.all_to_all(ebuf[:-1].reshape(n_shards, C))
    recv_v = data.all_to_all(vbuf[:-1].reshape(n_shards, C)) > 0

    # -------- grouped expert compute (sort-based packing)
    R = n_shards * C
    rx = recv.reshape(R, d_loc)
    re = torch.where(recv_v.reshape(R), recv_e.reshape(R).long(),
                     torch.full((R,), E_loc, dtype=torch.long, device=dev))
    Ce = max(1, int(math.ceil(R / E_loc * cfg.moe_capacity_factor)))
    rrank = rank_within(re, E_loc + 1)
    ok = (re < E_loc) & (rrank < Ce)
    pos = torch.where(ok, re * Ce + rrank,
                      torch.full_like(re, E_loc * Ce))
    xe = x.new_zeros((E_loc * Ce + 1, d_loc))
    xe[pos] = rx
    xe = xe[:-1].reshape(E_loc, Ce, d_loc)
    f_sharded = not two_d and p["w_gate"].shape[2] < cfg.moe_d_ff
    ye = []
    for e in range(E_loc):
        if two_d:
            # weights (E_loc, d_loc, f): partial contraction over the local
            # d slice, one f-sized sum before the nonlinearity
            hg = row_parallel(xe[e], p["w_gate"][e], model)
            hu = row_parallel(xe[e], p["w_up"][e], model)
            ye.append(linear(F.silu(hg) * hu, p["w_down"][e]))
        else:
            # a sharded hidden width leaves a float32 partial sum, summed
            # over the model line after the combine
            ye.append(expert_ffn(xe[e], p["w_gate"][e], p["w_up"][e],
                                 p["w_down"][e], out_dtype=torch.float32
                                 if f_sharded else None))
    ye = torch.stack(ye)
    yflat = torch.cat([ye.reshape(E_loc * Ce, d_loc),
                       ye.new_zeros((1, d_loc))])
    back = torch.where(ok[:, None], yflat[pos],
                       yflat.new_zeros(())).reshape(n_shards, C, d_loc)
    ret = data.all_to_all(back)
    rflat = torch.cat([ret.reshape(n_shards * C, d_loc),
                       ret.new_zeros((1, d_loc))])
    contrib = rflat[slot].float() * wgt[:, None]
    contrib = torch.where(valid[:, None], contrib,
                          contrib.new_zeros(())).reshape(T, k, d_loc)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    if two_d:
        y = model.all_gather(y, dim=1)                           # (T, d)
    elif f_sharded:
        y = model.all_reduce(y)

    f_e, p_e = balance_stats(cfg, probs, ids)
    dropped = data.all_reduce(((~valid).sum()
                               + (recv_v.reshape(R) & ~ok).sum()).reshape(1))
    return y.to(x.dtype), f_e, p_e, dropped


def apply_moe_ep(cfg, p, x, mesh, *, data_axes=("data",),
                 model_axis="model"):
    """x: (B, S, d), this rank's rows (its data shard, or every row where
    the batch is replicated); ``p``: this rank's expert shard. Experts
    shard over the innermost data axis. Dispatch runs in token chunks
    (``moe_dispatch_chunk``) so the all-to-all buffers stay bounded.
    Returns (y, aux) with the global aux loss: the linear statistics are
    averaged over the data line first, then combined (the dense
    single-rank value)."""
    B, S, d = x.shape
    data = mesh.group(data_axes[-1])
    stats = mesh.group(data_axes)
    model = mesh.group(model_axis)
    two_d = (cfg.moe_2d_dispatch and model.size > 1 and d % model.size == 0
             and p["w_gate"].shape[1] < d)
    T = B * S
    x2 = x.reshape(T, d)
    chunk = cfg.moe_dispatch_chunk
    if chunk and T > chunk and T % chunk == 0:
        parts = [_moe_local(cfg, p, xc, data, model, two_d)
                 for xc in x2.split(chunk)]
        y = torch.cat([pt[0] for pt in parts])
        f_e = torch.stack([pt[1] for pt in parts]).mean(0)
        p_e = torch.stack([pt[2] for pt in parts]).mean(0)
    else:
        y, f_e, p_e, _ = _moe_local(cfg, p, x2, data, model, two_d)
    f_e = stats.all_reduce(f_e) / stats.size
    p_e = stats.all_reduce(p_e) / stats.size
    aux = cfg.n_experts * torch.sum(f_e * p_e)
    return y.reshape(B, S, d), aux


def apply_moe_ep_replicated(cfg, p, x, mesh, *, ep_axis="data",
                            model_axis="model"):
    """Replicated-token expert parallelism for tiny query regions: every
    rank holds every token, computes its local experts for all of them
    with the gates of the experts it does not hold zeroed, and a sum
    over the mesh (data, then model where the hidden width is sharded)
    combines them. No all-to-all."""
    B, S, d = x.shape
    ep = mesh.group(ep_axis)
    tp = _hidden_tp(cfg, p, mesh.group(model_axis))
    x2 = x.reshape(B * S, d)
    probs, w, ids = route(cfg, p, x2)
    E_loc = p["w_gate"].shape[0]
    off = ep.index * E_loc
    comb = torch.zeros_like(probs).scatter(1, ids, w)           # (T, E)
    y = torch.zeros(x2.shape, dtype=torch.float32, device=x.device)
    for e in range(E_loc):
        ye = expert_ffn(x2, p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                        out_dtype=torch.float32 if tp is not None else None)
        y = torch.addcmul(y, ye, comb[:, off + e:off + e + 1])
    y = ep.all_reduce(y)
    if tp is not None:
        y = tp.all_reduce(y)
    aux = load_balance_loss(cfg, probs, ids)
    return y.reshape(B, S, d).to(x.dtype), aux


def apply_moe(cfg, p, x, mesh=None, data_axes=None, train=False):
    """The MoE FFN by placement: expert parallelism on a mesh whose data
    extent is above one (``moe_impl`` "ep" or "auto"; ``data_axes`` the
    mesh's by default, () for the replicated-token path), else the dense
    path (over the model line's hidden shards, on a mesh)."""
    if mesh is not None and cfg.moe_impl in ("ep", "auto") and not train:
        if data_axes is None:
            data_axes = mesh.data_axes
        if not data_axes:
            if mesh.shape.get("data", 1) > 1:
                return apply_moe_ep_replicated(cfg, p, x, mesh)
        elif mesh.shape.get(data_axes[-1], 1) > 1:
            return apply_moe_ep(cfg, p, x, mesh, data_axes=data_axes)
    tp = mesh.model_group if mesh is not None else None
    return apply_moe_dense(cfg, p, x, train=train, tp=tp)
