"""Carry weights and caches across from the JAX package's layouts.

The caller turns the JAX pytree into numpy first (for example
``jax.tree.map(np.asarray, params)``), so this module needs neither JAX
nor ``repro``. The JAX package stacks each pattern position's layers
along a leading ``reps`` axis (``lax.scan``); the port keeps one entry
per layer in layout order, so both sides compute the same function.
``params_to_jax`` goes the other way, to numpy leaves in the JAX
package's layout (what its checkpoints hold).
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16 from JAX
            t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, fn) for v in x)
    return fn(x)


def _unstack(groups) -> List[Any]:
    """Scan groups (one pytree per pattern position, leaves (reps, ...))
    -> per-layer pytrees in layout order."""
    out = []
    if groups:
        reps = len(next(iter(_leaves(groups[0]))))
        for r in range(reps):
            for g in groups:
                out.append(_tree(g, lambda a: a[r]))
    return out


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def params_from_jax(tree: dict, device, dtype=None) -> dict:
    """JAX ``init_params`` pytree (numpy or tensor leaves) -> the port's
    params:
    ``embed``, ``out_norm``, ``lm_head`` and the per-layer list."""
    conv = lambda a: to_tensor(a, device, dtype)  # noqa: E731
    out = {k: conv(tree[k]) for k in ("embed", "out_norm", "lm_head")
           if k in tree}
    if "frontend_proj" in tree:
        raise NotImplementedError("modality frontends are ROADMAP A13")
    layers = _unstack(tree["scan"]) + list(tree["tail"])
    out["layers"] = [_tree(p, conv) for p in layers]
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array of its own dtype (numpy
    has no bfloat16: such a tensor raises)."""
    return t.detach().cpu().numpy()


def _stack(layers, stack) -> Any:
    """Per-layer pytrees of one pattern position -> one pytree whose
    leaves stack the layers along a leading ``reps`` axis."""
    if isinstance(layers[0], dict):
        return {k: _stack([g[k] for g in layers], stack) for k in layers[0]}
    return stack(layers)


def jax_layout(params: dict, cfg, leaf=lambda t: t.detach(),
               stack=torch.stack) -> dict:
    """The port's params rearranged into the JAX package's ``init_params``
    pytree (the inverse of ``params_from_jax``): layer
    ``r * len(cfg.pattern) + j`` becomes repetition ``r`` of ``"scan"``
    group ``j``; the last ``len(cfg.tail)`` layers are ``"tail"``. Each
    leaf goes through ``leaf``, each group's layers through ``stack``."""
    n_pos, reps = len(cfg.pattern), cfg.reps
    layers = [_tree(p, leaf) for p in params["layers"]]
    if len(layers) != reps * n_pos + len(cfg.tail):
        raise ValueError(f"{len(layers)} layers for a layout of {reps} x "
                         f"{n_pos} + {len(cfg.tail)}")
    out = {k: leaf(params[k]) for k in ("embed", "out_norm", "lm_head")
           if k in params}
    out["scan"] = tuple(
        _stack([layers[r * n_pos + j] for r in range(reps)], stack)
        for j in range(n_pos)) if reps else ()
    out["tail"] = tuple(layers[reps * n_pos:])
    return out


def params_to_jax(params: dict, cfg) -> dict:
    """The port's params -> the JAX package's pytree with numpy leaves;
    ``params_from_jax(params_to_jax(p, cfg), device)`` is ``p`` bit for
    bit."""
    return jax_layout(params, cfg, to_numpy, np.stack)


def cache_from_jax(cache: dict, device) -> List[tuple]:
    """JAX ``init_cache``/``apply_model`` cache pytree (numpy leaves,
    ``{"scan": ((k, v) stacked over reps, ...), "tail": ((k, v), ...)}``)
    -> the port's per-layer list of ``(k, v)``."""
    layers = _unstack(cache["scan"]) + list(cache["tail"])
    return [tuple(to_tensor(a, device) for a in kv) for kv in layers]
