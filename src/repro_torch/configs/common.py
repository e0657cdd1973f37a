"""Shared helpers for architecture configs."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


def smoke_variant(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family variant: <=2 pattern periods, d_model<=512,
    <=4 experts, small vocab. Used by the per-arch CPU smoke tests."""
    d = dict(
        name=cfg.name + "-smoke",
        n_layers=len(cfg.pattern),
        reps=0,  # recomputed from n_layers / pattern in __post_init__
        tail=(),
        d_model=min(cfg.d_model, 256),
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=1024,
        frontend_prefix_len=min(cfg.frontend_prefix_len, 16),
        tp=1,
        dtype="float32",
        param_dtype="float32",
        remat=False,
        mask_token_id=0,   # recompute from reduced vocab
        eos_token_id=1,
    )
    if cfg.n_experts:
        d.update(n_experts=4, moe_top_k=2, moe_d_ff=128)
    if cfg.lru_width:
        d.update(lru_width=256)
    d.update(over)
    return dataclasses.replace(cfg, **d)
