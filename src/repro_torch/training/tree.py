"""Pytree flattening in ``jax.tree.flatten``'s order, in pure Python.

The JAX package's checkpoints number their leaves in that order, and the
optimizer walks its leaves in it, so the port rebuilds it without JAX:
dict keys sorted, tuples and lists in order, ``None`` dropped (an empty
subtree). ``treedef_str`` spells the structure as ``str(treedef)`` does
(``PyTreeDef({'embed': *, 'scan': ({...},), 'tail': ()})``).
"""
from __future__ import annotations

from typing import Any, List, Tuple


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or x is None


def flatten(tree) -> Tuple[List[Any], Any]:
    """-> (leaves, treedef); ``unflatten(treedef, leaves)`` rebuilds the
    tree with the same container types."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return (dict, tuple((k, walk(x[k])) for k in sorted(x)))
        if isinstance(x, (list, tuple)):
            return (type(x), tuple(walk(v) for v in x))
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        kind, children = d
        if kind is dict:
            return {k: build(c) for k, c in children}
        return kind(build(c) for c in children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def treedef_str(treedef) -> str:
    def show(d):
        if d is None:
            return "None"
        if d == "*":
            return "*"
        kind, children = d
        if kind is dict:
            return "{" + ", ".join(f"{k!r}: {show(c)}"
                                   for k, c in children) + "}"
        body = ", ".join(show(c) for c in children)
        if kind is tuple:
            return f"({body},)" if len(children) == 1 else f"({body})"
        return f"[{body}]"

    return f"PyTreeDef({show(treedef)})"
