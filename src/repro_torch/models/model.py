"""Layout-driven transformer backbone — the PyTorch counterpart of
``repro.models.model``: ATTN / ATTN_LOCAL / MLSTM / SLSTM / RGLRU mixers
(the recurrent ones in ``models.recurrent``) × SWIGLU / GELU / MOE (the
dense path, ``models.moe``) / no FFN.

Params are a dict: ``embed (V, d)``, ``out_norm (d,)``, ``lm_head (d, V)``
(absent with tied embeddings), ``frontend_proj (F, d)`` (the modality
frontends' stub: precomputed patch or frame embeddings of width F are
projected to d) and ``layers``, a list with one dict per
layer in layout order (the JAX package's scan-stacked groups unstacked:
layer ``r * len(pattern) + i`` is repetition ``r`` of pattern position
``i``, then the tail). The cache is a list with one entry per layer: a
``(k, v)`` pair of ``(B, T, Hkv, D)`` buffers for an attention layer, the
mixer's state (``recurrent.RGLRUState`` / ``MLSTMState`` /
``SLSTMState``) for a recurrent one.

Three execution modes:
  encode  — full pass over (B, S); with a cache, writes the S tokens'
            KV at slots 0..S-1 (the block refresh).
  step    — one denoise iteration: a query region attends over
            [cache buffer || self]; cache unchanged.
  append  — like step, but writes the query tokens' KV into the cache
            at ``kv_valid`` offsets or at ``append_at`` slots
            (``self_kv_mix``: the dKV cache's frozen K/V stand in for
            the fresh ones where it holds).

Across ranks (``mesh``, a ``launch.mesh.Mesh``) the params are this
rank's shards as ``launch.sharding.SpecBuilder`` cuts them, and the
collectives are written out where GSPMD inserts them for the reference:
a vocabulary-sharded embedding is looked up where it holds the token and
summed over the model line; q/k/v and gate/up are column-parallel, o
and down row-parallel with an ``all_reduce`` over the model line after
them; the vocabulary-sharded head's logits are gathered over the model
line into whole rows; a sharded ``frontend_proj`` (d over model) is
gathered the same way. A dimension that does not divide the line stays
whole (the spec builder's guard), and the code reads which from the
shards' widths. The reference's ``_seq_shard`` (a sequence-parallel
layout hint for GSPMD between layers) has no counterpart: it moves no
value, and the port's explicit ``all_reduce`` leaves every rank of the
model line the whole residual stream.

Unlike the JAX package, the cache buffers are updated in place (one KV
buffer per decode state instead of one per call), the recurrent states
too (a captured graph reads and writes the same buffers); the returned
cache is the same list.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import linear
from repro_torch.models import recurrent as rec
from repro_torch.models.config import (ATTN, ATTN_LOCAL, GELU, MOE, NONE,
                                       SWIGLU, LayerSpec, ModelConfig)
from repro_torch.models.heads import plan_heads
from repro_torch.models.layers import (apply_attention, apply_ffn,
                                       attention_kv_mask, dense_init,
                                       derived, init_attention, init_ffn,
                                       rms_norm, rope_table, softcap)
from repro_torch.models.moe import apply_moe, init_moe

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class ModelOutput(NamedTuple):
    logits: torch.Tensor        # (B, S, V) float32, or hidden with skip_head
    cache: Any                  # the (in-place updated) cache; None in step
    kv_valid: Any
    aux_loss: torch.Tensor      # () float32: the MoE layers' load-balance
                                # losses summed in layout order (0 if none)


def _check_layer(spec: LayerSpec) -> None:
    """Refuse a layer the port has no counterpart for."""
    if spec.mixer not in (ATTN, ATTN_LOCAL, *rec.APPLY):
        raise ValueError(f"layer {spec}: unknown mixer {spec.mixer!r}")
    if spec.ffn not in (SWIGLU, GELU, MOE, NONE):
        raise ValueError(f"layer {spec}: unknown FFN {spec.ffn!r}")


# ------------------------------------------------------------- init

def init_layer(generator: torch.Generator, cfg: ModelConfig,
               spec: LayerSpec, dtype) -> dict:
    _check_layer(spec)
    dev = generator.device
    p: dict = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}
    if spec.mixer in rec.INIT:
        p["mixer"] = rec.INIT[spec.mixer](generator, cfg, dtype)
    else:
        plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
        p["mixer"] = init_attention(generator, cfg, plan, dtype)
    if spec.ffn != NONE:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
        p["ffn"] = init_moe(generator, cfg, dtype) if spec.ffn == MOE \
            else init_ffn(generator, cfg, spec.ffn, dtype)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator``, drawn on ``device`` (cuda unless
    named; the generator must live there too)."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on "
                         f"{device}: make the generator on the device")
    for spec in cfg.layout:
        _check_layer(spec)
    dtype = DTYPES[cfg.param_dtype]
    params: dict = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                            cfg.d_model, dtype),
        "out_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype)
    if cfg.frontend_embed_dim:
        params["frontend_proj"] = dense_init(
            generator, (cfg.frontend_embed_dim, cfg.d_model),
            cfg.frontend_embed_dim, dtype)
    params["layers"] = [init_layer(generator, cfg, spec, dtype)
                        for spec in cfg.layout]
    return params


# leaves that stay float32 whatever the model's dtype (the MoE router,
# as the JAX package keeps it)
FLOAT32_LEAVES = ("router",)


def params_to(params, device, _key=None):
    """A copy of a params (or cache) tree with every tensor on ``device``
    (or cast to a dtype: whatever ``Tensor.to`` takes). A cast to another
    float dtype leaves the ``FLOAT32_LEAVES`` in float32."""
    if isinstance(params, dict):
        return {k: params_to(v, device, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    if isinstance(device, torch.dtype) and _key in FLOAT32_LEAVES:
        return params.to(torch.float32)
    return params.to(device)


# ------------------------------------------------------------- LM head

def serving_head(cfg: ModelConfig, params) -> torch.Tensor:
    """The (d, V) LM head of a serving pass: ``lm_head``, or with tied
    embeddings one contiguous copy of ``embed.T`` (the GEMM kernel takes
    a row-major (K, N) operand only). The copy is built once per
    ``embed`` tensor and kept beside it while it lives and is not written
    in place (``layers.derived``), not per call, and is no leaf of the
    params tree: at gemma2-27b it is 2.36 GB. The decoder builds it when
    it takes its params, so no capture allocates it."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    embed = params["embed"]
    return derived("head", [embed], lambda: embed.detach().T.contiguous())


def serving_layout(cfg: ModelConfig, params) -> torch.Tensor:
    """Build every serving layout of ``params`` now (the tied head, the
    recurrent mixers' concatenated and padded weights), so that no
    capture allocates one; returns the head."""
    for spec, p in zip(cfg.layout, params["layers"]):
        if spec.mixer in rec.APPLY:
            rec.mixer_weights(spec.mixer, p["mixer"])
    return serving_head(cfg, params)


# ------------------------------------------------------------- caches

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> List[tuple]:
    """Empty per-layer caches in layout order, as the JAX package's
    ``init_cache`` lays them out: (B, max_len, Hkv, D) K and V buffers
    for an attention layer, the mixer's zero state for a recurrent one."""
    dtype = DTYPES[cfg.dtype]
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    shape = (batch, max_len, plan.pad_kv, cfg.head_dim)
    cache = []
    for spec in cfg.layout:
        _check_layer(spec)
        if spec.mixer in rec.APPLY:
            cache.append(rec.init_state(cfg, spec.mixer, batch, dtype,
                                        device))
        else:
            cache.append((torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device)))
    return cache


def cache_map(fn, *caches) -> List[tuple]:
    """``fn`` over the leaves of one or more caches of one layout (batch
    is axis 0 of every leaf), layer by layer, keeping each layer's
    tuple type."""
    out = []
    for layer, *rest in zip(*caches):
        leaves = [fn(*ts) for ts in zip(layer, *rest)]
        out.append(type(layer)(*leaves) if hasattr(layer, "_fields")
                   else tuple(leaves))
    return out


def cache_take_rows(cache: List[tuple], rows) -> List[tuple]:
    """Gather a sub-batch of every layer's KV or state (a copy)."""
    idx = torch.as_tensor(list(rows), dtype=torch.long,
                          device=cache[0][0].device)
    return cache_map(lambda t: t.index_select(0, idx), cache)


# ------------------------------------------------------------- layers

def _write_kv(buf, new, kv_valid) -> None:
    """buf: (B, P, H, D) <- new (B, S, H, D) at per-row offsets kv_valid
    (B,), in place. Offsets are clamped to [0, P - S] as the JAX
    package's ``dynamic_update_slice`` clamps them."""
    B, S = new.shape[:2]
    P = buf.shape[1]
    off = kv_valid.long().clamp(0, P - S)
    slots = off[:, None] + torch.arange(S, device=buf.device)[None]
    buf[torch.arange(B, device=buf.device)[:, None], slots] = new


def _write_kv_at(buf, new, idx) -> None:
    """Scatter new (B, S, H, D) into buf at per-token slots idx (B, S)."""
    B = new.shape[0]
    buf[torch.arange(B, device=buf.device)[:, None], idx.long()] = new


def _write_state(cache, st) -> None:
    """A recurrent layer's new state into its cache buffers, in place."""
    for buf, new in zip(cache, st):
        buf.copy_(new)


def _apply_recurrent(cfg, p, spec, h, *, cache, mode, cache_upto, train,
                     tp=None):
    """The recurrent mixer of a layer (``src/repro/models/model.py``'s
    branch): a pass with no cache scans from the zero state; a refresh
    (encode or append with ``cache_upto``) scans the prefix from the zero
    state, keeps the state at the prefix boundary in the cache, and scans
    the rest from it; otherwise the scan resumes from the cached state,
    and an append keeps the state after it. An encode without
    ``cache_upto`` scans from the zero state, as the reference does from
    the fresh cache it is given. ``step`` leaves the cache as it was."""
    fn = rec.APPLY[spec.mixer]
    kw = dict(return_state=True, train=train, tp=tp)
    if cache is None:
        return fn(cfg, p["mixer"], h, train=train, tp=tp)
    if mode in ("encode", "append") and cache_upto is not None:
        out1, st = fn(cfg, p["mixer"], h[:, :cache_upto], **kw)
        out2, _ = fn(cfg, p["mixer"], h[:, cache_upto:], state=st, **kw)
        _write_state(cache, st)
        return torch.cat([out1, out2], dim=1)
    out, st = fn(cfg, p["mixer"], h, state=None if mode == "encode"
                 else cache, **kw)
    if mode != "step":
        _write_state(cache, st)
    return out


def _tp_if(tp, local: int, full: int):
    """The model line where a width is this rank's shard of ``full``."""
    return tp if (tp is not None and local < full) else None


def apply_layer(cfg, p, spec: LayerSpec, x, *, q_pos, cache, kv_valid,
                mode, append_at=None, self_kv_mix=None, kv_pos=None,
                rope=None, kv_mask=None, cache_upto=None, use_kernels=False,
                train=False, mesh=None, data_axes=None):
    """Returns (y, cache, aux); the cache is written in place; aux is the
    MoE layer's load-balance loss, None for other FFNs. ``kv_pos``,
    ``rope`` and ``kv_mask`` are the pass's key positions, RoPE table and
    key validity, built once by ``apply_model`` for every layer.
    ``self_kv_mix`` (B, Sq) bool (dKV cache): where it holds, the query
    token's K/V is the cache's at its position instead of a fresh one.
    ``cache_upto`` is the block refresh's prefix boundary, which only a
    recurrent layer reads (``_apply_recurrent``). ``mesh``: the params
    are this rank's shards (module docstring); ``data_axes`` the MoE
    layer's (``moe.apply_moe``: the mesh's by default, () for the
    replicated-token path, as the reference passes them)."""
    tp = mesh.model_group if mesh is not None else None
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    window = cfg.local_window if spec.mixer == ATTN_LOCAL else 0
    B = x.shape[0]
    attn_tp = None if spec.mixer in rec.APPLY else _tp_if(
        tp, p["mixer"]["wo"].shape[0],
        plan_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp).pad_q)
    if spec.mixer in rec.APPLY:
        out = _apply_recurrent(cfg, p, spec, h, cache=cache, mode=mode,
                               cache_upto=cache_upto, train=train, tp=tp)
    elif mode == "encode":
        out, kv = apply_attention(cfg, p["mixer"], h, q_pos=q_pos,
                                  window=window, return_kv=True, rope=rope,
                                  kv_mask=kv_mask, use_kernels=use_kernels,
                                  train=train, tp=attn_tp)
        if cache is not None:
            S = x.shape[1]
            if S > cache[0].shape[1]:
                raise ValueError(f"encode of {S} tokens into a "
                                 f"{cache[0].shape[1]}-slot cache")
            cache[0][:, :S] = kv[0].to(cache[0].dtype)
            cache[1][:, :S] = kv[1].to(cache[1].dtype)
    else:
        if kv_pos is None:
            kv_pos = cache_kv_positions(cache[0].shape[1], q_pos)
        override = None
        if self_kv_mix is not None:
            rows = torch.arange(B, device=x.device)[:, None]
            qi = q_pos.long()
            override = (self_kv_mix, cache[0][rows, qi], cache[1][rows, qi])
        out, kv = apply_attention(cfg, p["mixer"], h, q_pos=q_pos,
                                  kv_pos=kv_pos, kv_cache=cache,
                                  kv_valid=kv_valid, window=window,
                                  return_kv=True,
                                  self_kv_override=override, rope=rope,
                                  kv_mask=kv_mask, use_kernels=use_kernels,
                                  tp=attn_tp)
        if mode == "append":
            for buf, new in zip(cache, kv):
                if append_at is not None:
                    _write_kv_at(buf, new.to(buf.dtype), append_at)
                else:
                    _write_kv(buf, new.to(buf.dtype), kv_valid)
    x = x + out
    aux = None
    if spec.ffn != NONE:
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        if spec.ffn == MOE:
            y, aux = apply_moe(cfg, p["ffn"], h2, mesh=mesh,
                               data_axes=data_axes, train=train)
        else:
            y = apply_ffn(p["ffn"], h2, spec.ffn, train=train,
                          tp=_tp_if(tp, p["ffn"]["w_down"].shape[0],
                                    cfg.d_ff))
        x = x + y
    return x, cache, aux


def cache_kv_positions(P_len: int, q_pos):
    """Positions of [cache || self] keys: cache slot i holds position i."""
    B = q_pos.shape[0]
    cache_pos = torch.arange(P_len, dtype=torch.int32,
                             device=q_pos.device)[None].expand(B, P_len)
    return torch.cat([cache_pos, q_pos], dim=1)


# ------------------------------------------------------------- forward

def _embed(cfg, params, tokens, tp):
    """Token embeddings; with a vocabulary-sharded ``embed`` each rank
    looks up the tokens it holds (zeros elsewhere) and the model line
    sums them: one nonzero term a row, so the sum is exact."""
    emb = params["embed"]
    if tp is None or emb.shape[0] == cfg.vocab_size:
        return emb[tokens.long()]
    rows = emb.shape[0]
    local = tokens.long() - tp.index * rows
    inside = (local >= 0) & (local < rows)
    x = emb[local.clamp(0, rows - 1)]
    return tp.all_reduce(torch.where(inside[..., None], x, x.new_zeros(())))


def _frontend(cfg, params, e, dtype, tp, train):
    """Frontend-width embeddings (``cfg.frontend_embed_dim``) projected to
    d through ``frontend_proj`` (``ops.linear``); d-wide ones as given.
    A proj sharded over d gives this rank's columns, gathered over the
    model line."""
    e = e.to(dtype)
    if not (cfg.frontend_embed_dim and e.shape[-1] == cfg.frontend_embed_dim):
        return e
    w = params["frontend_proj"]
    e = linear(e, w.to(dtype), train=train)
    if tp is not None and w.shape[1] < cfg.d_model:
        e = tp.all_gather(e, -1)
    return e


def apply_model(cfg: ModelConfig, params, *, tokens=None, embeds=None,
                prefix_embeds=None, positions=None,
                mode: str = "encode", cache=None, kv_valid=None,
                append_at=None, self_kv_mix=None,
                cache_upto: Optional[int] = None, skip_head: bool = False,
                use_kernels: bool = False, train: bool = False, mesh=None,
                data_axes=None) -> ModelOutput:
    """tokens: (B, S) int, or ``embeds`` (B, S, F or d) in their place;
    ``prefix_embeds`` (B, Sp, F or d): the modality frontends' stub
    (precomputed patch or frame embeddings), projected and prepended to
    the token embeddings before ``embed_scale``, so the pass covers
    Sp + S positions; positions: (B, S) of the whole pass. ``mesh``: the
    params are this rank's shards (module docstring); ``data_axes``: the
    MoE layers' (``apply_layer``). ``use_kernels`` routes the
    attention of every layer through ``kernels.ops.block_attention``.
    ``self_kv_mix`` (B, S) bool: the dKV cache's frozen tokens (their K/V
    is gathered from the cache at their position in every layer).
    ``cache_upto`` (the block-refresh prefix boundary) only matters to
    recurrent layers: their cached state is the state at that boundary.
    The key positions, the RoPE table and the key validity are built
    once per pass, not per layer, and only for a layout with attention.

    ``train=True`` is the training route (the JAX package's
    ``diffusion_loss``): an encode with no cache, plain attention and
    every product ``x @ w``, differentiable under autograd on any
    device; with ``cfg.remat`` each layer of the repeated pattern is
    recomputed in the backward pass (``jax.checkpoint`` in the
    reference). Without it, a product on the card goes through the GEMM
    kernel, whatever ``use_kernels`` says, and a tied head is
    ``serving_head``'s contiguous copy."""
    if mode not in ("encode", "step", "append"):
        raise ValueError(f"unknown mode {mode!r}")
    if train and (use_kernels or mode != "encode" or cache is not None):
        raise ValueError("train=True is an encode with no cache on the "
                         "plain attention (the kernels have no backward)")
    if mode != "encode" and cache is None:
        raise ValueError(f"mode={mode!r} needs a cache")
    dtype = DTYPES[cfg.dtype]
    tp = mesh.model_group if mesh is not None else None
    if tokens is not None:
        x = _embed(cfg, params, tokens, tp).to(dtype)
    else:
        x = _frontend(cfg, params, embeds, dtype, tp, train)
    if prefix_embeds is not None:
        x = torch.cat([_frontend(cfg, params, prefix_embeds, dtype, tp,
                                 train), x], dim=1)
    B, S = x.shape[:2]
    dev = x.device
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    if positions is None:
        positions = torch.arange(S, device=dev)[None].expand(B, S)
    positions = positions.to(torch.int32).contiguous()
    if kv_valid is None:
        kv_valid = torch.zeros((B,), dtype=torch.int32, device=dev)
    kv_valid = torch.as_tensor(kv_valid, device=dev)
    if kv_valid.dim() < 2:
        kv_valid = kv_valid.to(torch.int32).expand(B)

    layout = cfg.effective_layout()
    attn = [i for i, s in enumerate(layout) if s.mixer in (ATTN, ATTN_LOCAL)]
    rope = kv_pos = kv_mask = None
    if attn:
        rope = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        if mode != "encode":
            P_len = cache[attn[0]][0].shape[1]
            kv_pos = cache_kv_positions(P_len, positions)
            kv_mask = attention_kv_mask(kv_valid, P_len, S)
        elif use_kernels:
            kv_mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    remat = train and cfg.remat
    n_scan = cfg.reps * len(cfg.pattern)    # the reference's scanned layers
    aux = None
    for i, spec in enumerate(layout):
        def layer(p_i, x_i, spec=spec, c_i=cache[i] if cache is not None
                  else None):
            return apply_layer(cfg, p_i, spec, x_i, q_pos=positions,
                               cache=c_i, kv_valid=kv_valid, mode=mode,
                               append_at=append_at, self_kv_mix=self_kv_mix,
                               kv_pos=kv_pos, rope=rope, kv_mask=kv_mask,
                               cache_upto=cache_upto,
                               use_kernels=use_kernels, train=train,
                               mesh=mesh, data_axes=data_axes)
        if remat and i < n_scan:
            x, _, a = checkpoint(layer, params["layers"][i], x,
                                 use_reentrant=False)
        else:
            x, _, a = layer(params["layers"][i], x)
        if a is not None:
            aux = a if aux is None else aux + a
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=dev)

    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    if skip_head:
        logits = x  # final hidden states; caller owns the head projection
    else:
        if train:
            head = params["embed"].T if cfg.tie_embeddings \
                else params["lm_head"]
        else:
            head = serving_head(cfg, params)
        logits = linear(x, head.to(x.dtype), train=train)
        if tp is not None and head.shape[1] < cfg.vocab_size:
            logits = tp.all_gather(logits, -1)
        logits = logits.float()
        if cfg.logit_softcap:
            logits = softcap(logits, cfg.logit_softcap)

    new_cache = cache if mode != "step" else None
    if kv_valid.dim() == 2:  # bool-mask caches are managed by the caller
        new_valid = kv_valid
    else:
        new_valid = kv_valid + (S if mode in ("encode", "append") else 0)
    return ModelOutput(logits, new_cache, new_valid, aux)
