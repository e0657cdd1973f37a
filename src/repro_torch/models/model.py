"""Layout-driven transformer backbone — the PyTorch counterpart of
``repro.models.model`` for the dense families (ATTN / ATTN_LOCAL mixers
× SWIGLU / GELU FFNs). Recurrent and MoE layers wait for ROADMAP A13.

Params are a dict: ``embed (V, d)``, ``out_norm (d,)``, ``lm_head (d, V)``
(absent with tied embeddings) and ``layers``, a list with one dict per
layer in layout order (the JAX package's scan-stacked groups unstacked:
layer ``r * len(pattern) + i`` is repetition ``r`` of pattern position
``i``, then the tail). The cache is a list with one ``(k, v)`` pair of
``(B, T, Hkv, D)`` buffers per layer.

Three execution modes:
  encode  — full pass over (B, S); with a cache, writes the S tokens'
            KV at slots 0..S-1 (the block refresh).
  step    — one denoise iteration: a query region attends over
            [cache buffer || self]; cache unchanged.
  append  — like step, but writes the query tokens' KV into the cache
            at ``kv_valid`` offsets or at ``append_at`` slots
            (``self_kv_mix``: the dKV cache's frozen K/V stand in for
            the fresh ones where it holds).

Unlike the JAX package, the cache buffers are updated in place (one KV
buffer per decode state instead of one per call); the returned cache is
the same list.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.kernels.ops import linear
from repro_torch.models.config import (ATTN, ATTN_LOCAL, NONE, LayerSpec,
                                       ModelConfig)
from repro_torch.models.heads import plan_heads
from repro_torch.models.layers import (apply_attention, apply_ffn,
                                       attention_kv_mask, dense_init,
                                       init_attention, init_ffn, rms_norm,
                                       rope_table, softcap)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class ModelOutput(NamedTuple):
    logits: torch.Tensor        # (B, S, V) float32, or hidden with skip_head
    cache: Any                  # the (in-place updated) cache; None in step
    kv_valid: Any


def _check_dense(spec: LayerSpec) -> None:
    if spec.mixer not in (ATTN, ATTN_LOCAL) or spec.ffn not in (
            "swiglu", "gelu", NONE):
        raise NotImplementedError(
            f"layer {spec}: recurrent and MoE layers are ROADMAP A13")


# ------------------------------------------------------------- init

def init_layer(generator: torch.Generator, cfg: ModelConfig,
               spec: LayerSpec, dtype) -> dict:
    _check_dense(spec)
    dev = generator.device
    p: dict = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    p["mixer"] = init_attention(generator, cfg, plan, dtype)
    if spec.ffn != NONE:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
        p["ffn"] = init_ffn(generator, cfg, spec.ffn, dtype)
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
        _check_dense(spec)
    dtype = DTYPES[cfg.param_dtype]
    params: dict = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                            cfg.d_model, dtype),
        "out_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype)
    params["layers"] = [init_layer(generator, cfg, spec, dtype)
                        for spec in cfg.layout]
    return params


def params_to(params, device):
    """A copy of a params (or cache) tree with every tensor on ``device``
    (or cast to a dtype: whatever ``Tensor.to`` takes)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)


# ------------------------------------------------------------- caches

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> List[tuple]:
    """Empty per-layer KV buffers, (B, max_len, Hkv, D) each."""
    dtype = DTYPES[cfg.dtype]
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    shape = (batch, max_len, plan.pad_kv, cfg.head_dim)
    cache = []
    for spec in cfg.layout:
        _check_dense(spec)
        cache.append((torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device)))
    return cache


def cache_take_rows(cache: List[tuple], rows) -> List[tuple]:
    """Gather a sub-batch of every layer's KV (a copy)."""
    idx = torch.as_tensor(list(rows), dtype=torch.long,
                          device=cache[0][0].device)
    return [(k.index_select(0, idx), v.index_select(0, idx))
            for k, v in cache]


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


def apply_layer(cfg, p, spec: LayerSpec, x, *, q_pos, cache, kv_valid,
                mode, append_at=None, self_kv_mix=None, kv_pos=None,
                rope=None, kv_mask=None, use_kernels=False, train=False):
    """Returns (y, cache); the cache is written in place. ``kv_pos``,
    ``rope`` and ``kv_mask`` are the pass's key positions, RoPE table and
    key validity, built once by ``apply_model`` for every layer.
    ``self_kv_mix`` (B, Sq) bool (dKV cache): where it holds, the query
    token's K/V is the cache's at its position instead of a fresh one."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    window = cfg.local_window if spec.mixer == ATTN_LOCAL else 0
    B = x.shape[0]
    if mode == "encode":
        out, kv = apply_attention(cfg, p["mixer"], h, q_pos=q_pos,
                                  window=window, return_kv=True, rope=rope,
                                  kv_mask=kv_mask, use_kernels=use_kernels,
                                  train=train)
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
                                  kv_mask=kv_mask, use_kernels=use_kernels)
        if mode == "append":
            for buf, new in zip(cache, kv):
                if append_at is not None:
                    _write_kv_at(buf, new.to(buf.dtype), append_at)
                else:
                    _write_kv(buf, new.to(buf.dtype), kv_valid)
    x = x + out
    if spec.ffn != NONE:
        x = x + apply_ffn(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps),
                          spec.ffn, train=train)
    return x, cache


def cache_kv_positions(P_len: int, q_pos):
    """Positions of [cache || self] keys: cache slot i holds position i."""
    B = q_pos.shape[0]
    cache_pos = torch.arange(P_len, dtype=torch.int32,
                             device=q_pos.device)[None].expand(B, P_len)
    return torch.cat([cache_pos, q_pos], dim=1)


# ------------------------------------------------------------- forward

def apply_model(cfg: ModelConfig, params, *, tokens, positions=None,
                mode: str = "encode", cache=None, kv_valid=None,
                append_at=None, self_kv_mix=None,
                cache_upto: Optional[int] = None, skip_head: bool = False,
                use_kernels: bool = False, train: bool = False
                ) -> ModelOutput:
    """tokens: (B, S) int; positions: (B, S). ``use_kernels`` routes the
    attention of every layer through ``kernels.ops.block_attention``.
    ``self_kv_mix`` (B, S) bool: the dKV cache's frozen tokens (their K/V
    is gathered from the cache at their position in every layer).
    ``cache_upto`` (the block-refresh prefix boundary) only matters to
    recurrent layers, which the port does not have yet. The key
    positions, the RoPE table and the key validity are built once per
    pass, not per layer.

    ``train=True`` is the training route (the JAX package's
    ``diffusion_loss``): an encode with no cache, plain attention and
    every product ``x @ w``, differentiable under autograd on any
    device. Without it, a product on the card goes through the GEMM
    kernel, whatever ``use_kernels`` says."""
    if mode not in ("encode", "step", "append"):
        raise ValueError(f"unknown mode {mode!r}")
    if train and (use_kernels or mode != "encode" or cache is not None):
        raise ValueError("train=True is an encode with no cache on the "
                         "plain attention (the kernels have no backward)")
    if mode != "encode" and cache is None:
        raise ValueError(f"mode={mode!r} needs a cache")
    dtype = DTYPES[cfg.dtype]
    B, S = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens.long()].to(dtype)
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

    rope = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    kv_pos = kv_mask = None
    if mode == "encode":
        if use_kernels:
            kv_mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    else:
        P_len = cache[0][0].shape[1]
        kv_pos = cache_kv_positions(P_len, positions)
        kv_mask = attention_kv_mask(kv_valid, P_len, S)
    layout = cfg.effective_layout()
    for i, spec in enumerate(layout):
        x, _ = apply_layer(cfg, params["layers"][i], spec, x, q_pos=positions,
                           cache=cache[i] if cache is not None else None,
                           kv_valid=kv_valid, mode=mode,
                           append_at=append_at, self_kv_mix=self_kv_mix,
                           kv_pos=kv_pos, rope=rope, kv_mask=kv_mask,
                           use_kernels=use_kernels, train=train)

    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    if skip_head:
        logits = x  # final hidden states; caller owns the head projection
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = linear(x, head.to(x.dtype), train=train).float()
        if cfg.logit_softcap:
            logits = softcap(logits, cfg.logit_softcap)

    new_cache = cache if mode != "step" else None
    if kv_valid.dim() == 2:  # bool-mask caches are managed by the caller
        new_valid = kv_valid
    else:
        new_valid = kv_valid + (S if mode in ("encode", "append") else 0)
    return ModelOutput(logits, new_cache, new_valid)
