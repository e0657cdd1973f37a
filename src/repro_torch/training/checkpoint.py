"""Checkpoints in the JAX package's format (``repro.training.checkpoint``).

``<path>.npz`` holds one array ``leaf_{i}`` per leaf of the JAX
``init_params`` pytree, numbered in ``jax.tree.flatten`` order, and
``<path>.json`` holds ``treedef``, ``n_leaves``, ``dtypes`` and
``metadata``. The port's params are rearranged into that pytree
(``bridge.jax_layout``) on the way out and back (``params_from_jax``) on
the way in, so either package reads what the other wrote.

numpy has no bfloat16: the JAX package writes such a leaf as 2-byte
void (``|V2``), and so does the port. ``restore`` reads the ``dtypes``
list to put the bits back into a bfloat16 tensor; it never reads a
leaf's bytes as another dtype.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.bridge import jax_layout, params_from_jax
from repro_torch.training import tree


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor of its recorded dtype."""
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise ValueError(f"a leaf stored as {a.dtype} where the .json "
                         f"says {dtype}: its bits are not read as another "
                         "dtype")
    return torch.from_numpy(np.ascontiguousarray(a))


def save(path: str, params: dict, cfg, metadata: dict | None = None) -> None:
    """Write the port's ``params`` (of config ``cfg``) as the JAX package
    writes its ``init_params`` pytree."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, treedef = tree.flatten(jax_layout(params, cfg))
    np.savez(path + ".npz", **{f"leaf_{i}": _host(l)
                               for i, l in enumerate(leaves)})
    with open(path + ".json", "w") as f:
        json.dump({"treedef": tree.treedef_str(treedef),
                   "n_leaves": len(leaves),
                   "dtypes": [_dtype_name(l.dtype) for l in leaves],
                   "metadata": metadata or {}}, f)


def restore(path: str, like: dict, cfg) -> dict:
    """Read a checkpoint into the port's params, shaped and typed like
    ``like`` (params of ``cfg``) and on its device. As in the JAX
    package, the leaf count and every shape must match, and a leaf
    stored in another float dtype is cast to ``like``'s."""
    shape_of = lambda ls: torch.empty(  # noqa: E731  (no copy of like)
        (len(ls), *ls[0].shape), dtype=ls[0].dtype, device="meta")
    want, treedef = tree.flatten(jax_layout(like, cfg, lambda t: t,
                                            shape_of))
    with open(path + ".json") as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(path + ".npz") as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        if n != len(want) or len(dtypes) != n:
            raise ValueError(f"checkpoint/model structure mismatch: {n} "
                             f"leaves stored, {len(want)} in the model")
        loaded = [_leaf(z[f"leaf_{i}"], dtypes[i]) for i in range(n)]
    for i, (a, w) in enumerate(zip(loaded, want)):
        if a.shape != w.shape:
            raise ValueError(f"shape mismatch at leaf_{i}: "
                             f"{tuple(a.shape)} vs {tuple(w.shape)}")
    cast = [a.to(w.dtype) for a, w in zip(loaded, want)]
    return params_from_jax(tree.unflatten(treedef, cast),
                           like["embed"].device)


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f).get("metadata", {})
