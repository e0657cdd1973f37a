"""Masked-diffusion training objective (LLaDA, Nie et al. 2025): the
port's ``repro.training.loss``.

Forward process: sample t ~ U(0.05, 1) per example; independently mask
each (loss-eligible) token with probability t. Reverse model predicts
the original token at masked positions under *bidirectional* attention.
Loss = cross-entropy at masked positions, importance-weighted by 1/t —
the ELBO weighting of masked discrete diffusion.

The reference draws the noise inside its loss from a JAX key; here the
draw (``draw_noise``, from a ``torch.Generator``) and the loss given the
draw (``loss_given_noise``) are two functions, so a test can hand the
port the JAX package's own ``(t, mask)``. The model runs on its training
route (``apply_model(train=True)``): plain attention and ``x @ w``, as
the reference trains, differentiable under autograd.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import linear
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softcap
from repro_torch.models.model import apply_model

# above this many logits per row, the CE streams the head (the reference's
# ``vocab_size * S > 4_000_000``)
STREAM_CE_ABOVE = 4_000_000


def chunked_ce(cfg: ModelConfig, params, hidden, tokens, weights,
               chunk: int = 512, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed cross-entropy: projects hidden -> logits one sequence
    chunk at a time so the (B, S, V) logits tensor is never materialized.
    ``mesh``: the head is this rank's vocabulary columns where it is
    sharded, and each chunk's logits are gathered over the model line
    into whole rows (as ``apply_model`` gathers its head's).

    Returns (sum of weighted nll, sum of weighted argmax-correct)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tp = mesh.model_group if (mesh is not None
                              and head.shape[1] < cfg.vocab_size) else None
    B, S, D = hidden.shape
    n = max(1, -(-S // chunk))
    pad = n * chunk - S
    if pad:  # zero-weight padding contributes nothing to either sum
        hidden = F.pad(hidden, (0, 0, 0, pad))
        tokens = F.pad(tokens, (0, pad))
        weights = F.pad(weights, (0, pad))
    c = (S + pad) // n
    nll, correct = [], []
    for i in range(n):
        h = hidden[:, i * c:(i + 1) * c]
        t = tokens[:, i * c:(i + 1) * c].long()
        w = weights[:, i * c:(i + 1) * c]
        logits = linear(h, head.to(h.dtype), train=True)
        if tp is not None:
            logits = tp.all_gather(logits, -1)
        logits = logits.float()
        if cfg.logit_softcap:
            logits = softcap(logits, cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        tok_logit = torch.gather(logits, -1, t[..., None])[..., 0]
        nll.append(((lse - tok_logit) * w).sum())
        correct.append(((logits.argmax(-1) == t) * w).sum())
    return torch.stack(nll).sum(), torch.stack(correct).sum()


def frontend_draw(loss_mask: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward process's draw for a (B, S) ``loss_mask`` as the
    reference's frontend step (``_dl_frontend``) makes it: ``t`` (B, 1)
    float32 in [0.05, 1) and the masked positions (B, S) bool, no
    position forced. On the generator's device."""
    B, S = loss_mask.shape
    dev = generator.device
    t = 0.05 + 0.95 * torch.rand((B, 1), generator=generator, device=dev)
    mask = (torch.rand((B, S), generator=generator, device=dev) < t) \
        & loss_mask.to(dev)
    return t, mask


def draw_noise(loss_mask: torch.Tensor, generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``frontend_draw`` with the first loss position forced in a row that
    drew none (a row with no mask gives no signal): the reference's
    ``diffusion_loss`` draw."""
    t, mask = frontend_draw(loss_mask, generator)
    loss_mask = loss_mask.to(mask.device)
    none = ~mask.any(dim=1, keepdim=True)
    first = loss_mask.int().argmax(dim=1)
    forced = F.one_hot(first, loss_mask.shape[1]).bool() & loss_mask
    return t, mask | (none & forced)


def loss_given_noise(cfg: ModelConfig, params, tokens, t, mask, *,
                     aux_weight: float = 0.01, mesh=None,
                     prefix_embeds=None) -> Tuple[torch.Tensor, dict]:
    """The diffusion loss of ``tokens`` (B, S) given the draw ``(t,
    mask)`` -> (loss, {"ce", "aux", "masked_acc", "n_masked"}), every
    value a device tensor. ``mesh``: the params are this rank's shards
    (``apply_model``). ``prefix_embeds`` (B, Sp, F): the pass is
    conditioned on a frozen (stub) frontend prefix and the loss taken
    over the token region after it, the CE streamed (the reference's
    ``_dl_frontend``)."""
    S = tokens.shape[1]
    tokens = tokens.long()
    x = torch.where(mask, cfg.mask_token_id, tokens)
    w = mask.float() / t                                  # 1/t ELBO weight
    n_mask = mask.sum()
    Pf = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    big = cfg.vocab_size * S > STREAM_CE_ABOVE or Pf > 0  # stream the CE
    out = apply_model(cfg, params, tokens=x, prefix_embeds=prefix_embeds,
                      mode="encode", skip_head=big, train=True, mesh=mesh)
    denom = torch.clamp_min(w.sum(), 1e-6)
    if big:
        nll, correct = chunked_ce(cfg, params, out.logits[:, Pf:], tokens,
                                  w, mesh=mesh)
        ce = nll / denom
        acc = correct / denom
    else:
        logp = torch.log_softmax(out.logits, dim=-1)
        tok_lp = torch.gather(logp, -1, tokens[..., None])[..., 0]
        ce = -(tok_lp * w).sum() / denom
        acc = ((out.logits.argmax(-1) == tokens) & mask).sum() \
            / torch.clamp_min(n_mask, 1)
    aux = out.aux_loss                  # the MoE layers' load balance
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "masked_acc": acc,
                  "n_masked": n_mask}


def diffusion_loss(cfg: ModelConfig, params, tokens, loss_mask,
                   generator: torch.Generator, *, aux_weight: float = 0.01,
                   mesh=None) -> Tuple[torch.Tensor, dict]:
    """The reference's ``diffusion_loss``: a draw from ``generator``, then
    the loss given it."""
    t, mask = draw_noise(loss_mask, generator)
    return loss_given_noise(cfg, params, tokens, t, mask,
                            aux_weight=aux_weight, mesh=mesh)
