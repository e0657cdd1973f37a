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

# the params leaves outside the layers, where a config has them
TOP_LEVEL = ("embed", "out_norm", "lm_head", "frontend_proj")


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy (or ml_dtypes bfloat16) array or tensor on ``device``; a
    floating one cast to ``dtype`` when it is given."""
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
        items = [_tree(v, fn) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return fn(x)


def _convert(x, device, dtype, key=None):
    """``to_tensor`` over a pytree; a leaf under one of the
    ``FLOAT32_LEAVES`` keys is kept float32 when ``dtype`` is given."""
    from repro_torch.models.model import FLOAT32_LEAVES
    if isinstance(x, dict):
        return {k: _convert(v, device, dtype, k) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_convert(v, device, dtype, key) for v in x)
    keep = dtype is not None and key in FLOAT32_LEAVES
    return to_tensor(x, device, torch.float32 if keep else dtype)


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
    ``embed``, ``out_norm``, ``lm_head``, ``frontend_proj`` (the
    modality frontends) and the per-layer list. A
    ``dtype`` casts every floating leaf but the ``FLOAT32_LEAVES`` (the
    MoE router), which stay float32 as in the JAX package."""
    out = {k: _convert(tree[k], device, dtype) for k in TOP_LEVEL
           if k in tree}
    layers = _unstack(tree["scan"]) + list(tree["tail"])
    out["layers"] = [_convert(p, device, dtype) for p in layers]
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
    out = {k: leaf(params[k]) for k in TOP_LEVEL if k in params}
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
    ``{"scan": (layer caches stacked over reps, ...), "tail": (...)}``)
    -> the port's per-layer list: ``(k, v)`` for an attention layer, the
    port's state NamedTuple (``models.recurrent``, matched by field
    names) for a recurrent one."""
    from repro_torch.models import recurrent as rec
    states = {t._fields: t for t in (rec.RGLRUState, rec.MLSTMState,
                                     rec.SLSTMState)}
    out = []
    for layer in _unstack(cache["scan"]) + list(cache["tail"]):
        leaves = [to_tensor(a, device) for a in layer]
        kind = states.get(getattr(layer, "_fields", None))
        out.append(kind(*leaves) if kind else tuple(leaves))
    return out
