"""Training loop: masked-diffusion LM on the synthetic corpus (the port's
``repro.training.train``).

Trains the port's params with the reference's recipe: the same batches
(numpy-seeded), its loss and AdamW arithmetic, its defaults and its
logging cadence. Runs on CUDA unless ``device`` names another; every
random draw (the initial weights when none are given, then the forward
process's noise) comes from one ``torch.Generator`` per ``train`` call,
seeded with ``TrainConfig.seed``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.data.synthetic import ArithmeticDataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.obs.log import get_logger, setup_logging
from repro_torch.training import checkpoint, tree
from repro_torch.training.loss import draw_noise, loss_given_noise
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)

log = get_logger(__name__)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 300
    batch_size: int = 32
    seq_len: int = 96
    seed: int = 0
    log_every: int = 25
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    checkpoint_path: Optional[str] = None


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """-> ``train_step(params, opt_state, tokens, noise)``: the loss
    given ``noise = (t, mask)`` (``loss.draw_noise``, which applies the
    loss mask), its gradient by autograd and one AdamW step over the
    params' leaves in ``jax.tree.flatten`` order. Returns (params,
    opt_state, metrics), the metrics device tensors bar ``lr``."""
    def train_step(params, opt_state: AdamWState, tokens, noise):
        leaves, treedef = tree.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_given_noise(
            cfg, tree.unflatten(treedef, leaves), tokens, *noise)
        # a leaf the loss does not reach (a frontend's ``frontend_proj``
        # in a token-only step) gets zeros, as ``jax.grad`` gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        new, opt_state, opt_metrics = adamw_update(
            opt_cfg, list(grads), opt_state, [p.detach() for p in leaves])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return tree.unflatten(treedef, new), opt_state, metrics
    return train_step


def train(cfg: ModelConfig, tcfg: TrainConfig, params=None, verbose=True,
          device=None):
    """Train ``cfg`` (from ``init_params`` unless ``params`` is given) ->
    (params, history). Each history entry holds the step's metrics as
    floats (``loss``, ``ce``, ``aux``, ``masked_acc``, ``n_masked``,
    ``grad_norm``, ``lr``), ``step``, and ``elapsed_s``, the wall seconds
    since the first step began, read after the entry's values reached
    the host."""
    if verbose and not get_logger("repro_torch").handlers:
        setup_logging()
    device = resolve_device(device)
    tok = ByteTokenizer(cfg.vocab_size)
    ds = ArithmeticDataset(tok, seq_len=tcfg.seq_len, seed=tcfg.seed)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    if params is None:
        params = init_params(cfg, gen, device)
    opt_cfg = dataclasses.replace(tcfg.opt, total_steps=tcfg.steps)
    opt_state = adamw_init(opt_cfg, tree.flatten(params)[0])
    step_fn = make_train_step(cfg, opt_cfg)

    history = []
    t0 = time.perf_counter()
    for step in range(tcfg.steps):
        b = ds.batch(step, tcfg.batch_size)
        tokens = torch.as_tensor(b.tokens, device=device)
        loss_mask = torch.as_tensor(b.loss_mask, device=device)
        params, opt_state, m = step_fn(params, opt_state, tokens,
                                       draw_noise(loss_mask, gen))
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            m = {k: float(v) for k, v in m.items()}
            m["step"] = step
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            if verbose:
                log.info("step %5d loss %.4f masked_acc %.3f lr %.2e "
                         "(%.1fs)", step, m["loss"], m["masked_acc"],
                         m["lr"], m["elapsed_s"])
    if tcfg.checkpoint_path:
        checkpoint.save(tcfg.checkpoint_path, params, cfg,
                        {"steps": tcfg.steps, "config": cfg.name})
    return params, history
