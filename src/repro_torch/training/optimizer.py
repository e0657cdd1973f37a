"""AdamW on lists of tensors with the JAX package's arithmetic
(``repro.training.optimizer``): gradient clipping by the global norm,
bias-corrected moments kept in ``state_dtype``, decoupled weight decay
added to the update, and a warmup-cosine schedule, all in float32.

``torch.optim.AdamW`` is not used: its clip epsilon, where it applies
the weight decay and the order of its operations differ from the
reference's, and a port step must equal a reference step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Tuple

import torch

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: int
    m: List[torch.Tensor]
    v: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"    # "bfloat16" for memory-tight configs
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup to ``lr``, then cosine down to ``min_lr_frac * lr``,
    evaluated in float32 as the reference evaluates it."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * prog))
    lr = cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return float(lr)


def adamw_init(cfg: AdamWConfig, params: List[torch.Tensor]) -> AdamWState:
    dt = STATE_DTYPES[cfg.state_dtype]
    zeros = [torch.zeros(p.shape, dtype=dt, device=p.device) for p in params]
    return AdamWState(0, zeros, [z.clone() for z in zeros])


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32 (a device
    scalar: nothing waits for it)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: List[torch.Tensor],
                 state: AdamWState, params: List[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], AdamWState, dict]:
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"}).
    ``grad_norm`` is the norm before clipping, a device scalar."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0) \
        if cfg.grad_clip > 0 else 1.0
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = float(1 - _f32(cfg.b1) ** step)
    b2c = float(1 - _f32(cfg.b2) ** step)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, state.m, state.v):
        g = g.float() * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        update = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        new_p.append((p.float() - lr * update).to(p.dtype))
        new_m.append(mf.to(m.dtype))
        new_v.append(vf.to(v.dtype))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm,
                                                   "lr": lr}
