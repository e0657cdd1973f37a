"""Partition specs for params, optimizer state and caches: the PyTorch
counterpart of ``repro.launch.sharding``, with ``shard`` to cut a rank's
piece of a leaf by its spec.

Scheme (the reference's):
  * model axis: tensor parallel. Attention heads (padded per
    ``heads.plan_heads``), d_ff, per-expert hidden, the recurrent
    mixers' wide projections, vocab.
  * data axis: batch; in train mode additionally FSDP-shards the
    non-expert weight matrices along d_model/d_ff; MoE experts shard
    their expert axis here (expert parallelism) in every mode.
  * pod axis: pure data parallelism.

Every proposed spec is divisibility-guarded against the actual shape:
axes that don't divide fall back to replication (e.g. xlstm's 4 mLSTM
heads never shard over model=16; its wide projections do instead).

The trees are the port's: ``params`` is ``{"embed", "out_norm",
"lm_head"?, "frontend_proj"?, "layers": [one dict per layer]}`` and a
cache is one entry per layer, as ``models.model`` lays them out (the
JAX package's scan-stacked groups unstacked: a stacked spec's leading
``None`` goes with the stacking). ``P`` is the port's own partition
spec: one entry per dimension, an axis name, a tuple of names or None.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import (ATTN, ATTN_LOCAL, MLSTM, MOE, NONE,
                                       RGLRU, SLSTM, LayerSpec, ModelConfig)


class P:
    """A partition spec: entry ``i`` names the mesh axis (or axes)
    dimension ``i`` is split over, None where it is whole. A leaf of the
    port's pytrees (not a tuple), so spec trees flatten like params."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples and
    NamedTuples are nodes), zipped with trees of the same structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def _extent(names, mesh) -> int:
    ns = names if isinstance(names, tuple) else (names,)
    total = 1
    for n in ns:
        total *= mesh.shape[n]
    return total


def _guard(spec: P, shape, mesh) -> P:
    """Drop sharding on axes whose extent doesn't divide the dim."""
    out = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if names is None:
            out.append(None)
            continue
        out.append(names if dim % _extent(names, mesh) == 0 else None)
    return P(*out)


def _shapes(build):
    """The tree ``build()`` makes, with shapes only (fake tensors: no
    memory, no arithmetic)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return build()


class SpecBuilder:
    def __init__(self, cfg: ModelConfig, mesh, mode: str = "serve"):
        assert mode in ("serve", "train")
        self.cfg = cfg
        self.mesh = mesh
        self.model = "model" if "model" in mesh.axis_names else None
        self.fsdp = "data" if (mode == "train" and "data" in mesh.axis_names) \
            else None
        self.ep = "data" if "data" in mesh.axis_names else None
        self.dp: Tuple[str, ...] = tuple(a for a in mesh.axis_names
                                         if a in ("pod", "data"))
        self.mode = mode

    # ---------------- per-layer param specs

    def _attn(self) -> dict:
        m, f = self.model, self.fsdp
        d = {"wq": P(f, m, None), "wk": P(f, m, None), "wv": P(f, m, None),
             "wo": P(m, None, f)}
        if self.cfg.qk_norm:
            d["q_norm"] = P(None)
            d["k_norm"] = P(None)
        return d

    def _ffn(self, kind: str) -> dict:
        m, f = self.model, self.fsdp
        if kind == "swiglu":
            return {"w_gate": P(f, m), "w_up": P(f, m), "w_down": P(m, f)}
        return {"w_up": P(f, m), "w_down": P(m, f)}

    def _moe(self) -> dict:
        m, e = self.model, self.ep
        if self.cfg.moe_2d_dispatch:  # d over model, f full
            return {"router": P(None, None),
                    "w_gate": P(e, m, None), "w_up": P(e, m, None),
                    "w_down": P(e, None, m)}
        return {"router": P(None, None),
                "w_gate": P(e, None, m), "w_up": P(e, None, m),
                "w_down": P(e, m, None)}

    def _mlstm(self) -> dict:
        m, f = self.model, self.fsdp
        return {"w_up": P(f, m), "w_z": P(f, m), "conv": P(None, m),
                "wq": P(m, None, None), "wk": P(m, None, None),
                "wv": P(m, None, None), "w_i": P(m, None), "w_f": P(m, None),
                "gn": P(m), "w_down": P(m, f)}

    def _slstm(self) -> dict:
        m, f = self.model, self.fsdp
        d = {"gn": P(None),
             "w_ffn_up": P(f, m), "w_ffn_down": P(m, f)}
        for g in "zifo":
            d[f"w_{g}"] = P(f, m)
            d[f"r_{g}"] = P(None, None, None)
        return d

    def _rglru(self) -> dict:
        m, f = self.model, self.fsdp
        return {"w_in": P(f, m), "w_gate": P(f, m), "w_out": P(m, f),
                "conv": P(None, m), "w_a": P(None, m), "w_x": P(None, m),
                "lam": P(m)}

    def layer(self, spec: LayerSpec) -> dict:
        mixer = {ATTN: self._attn, ATTN_LOCAL: self._attn,
                 MLSTM: self._mlstm, SLSTM: self._slstm,
                 RGLRU: self._rglru}[spec.mixer]()
        d = {"norm1": P(None), "mixer": mixer}
        if spec.ffn != NONE:
            d["norm2"] = P(None)
            d["ffn"] = self._moe() if spec.ffn == MOE else self._ffn(spec.ffn)
        return d

    # ---------------- whole-model specs

    def params(self, shapes=None):
        """Guarded specs of the params tree; ``shapes`` is that tree (or
        any tree of tensors of its shapes), built with fake tensors when
        not given."""
        cfg = self.cfg
        m, f = self.model, self.fsdp
        specs = {"embed": P(m, f), "out_norm": P(None)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = P(f, m)
        if cfg.frontend_embed_dim:
            specs["frontend_proj"] = P(None, m)
        specs["layers"] = [self.layer(s) for s in cfg.layout]
        if shapes is None:
            from repro_torch.models.model import init_params
            shapes = _shapes(lambda: init_params(cfg, torch.Generator(),
                                                 device="cpu"))
        return tree_map(lambda sp, sh: _guard(sp, sh.shape, self.mesh),
                        specs, shapes, is_leaf=_is_spec)

    def cache(self, batch: int, max_len: int, serve_long: bool = False,
              ctx_parallel: bool = False, shapes=None):
        """Specs matching ``init_cache``'s structure, one per layer."""
        cfg = self.cfg
        m = self.model
        dp = self.dp
        b = (dp if len(dp) > 1 else dp[0]) if (dp and not ctx_parallel) \
            else None
        seq = "data" if ctx_parallel else None

        def one(spec: LayerSpec):
            from repro_torch.models import recurrent as rec
            if spec.mixer in (ATTN, ATTN_LOCAL):
                s = P(b, seq, m, None)
                return (s, s)
            if spec.mixer == MLSTM:
                return rec.MLSTMState(P(b, None, None, m), P(b, None, None),
                                      P(b, None), P(b, None, m))
            if spec.mixer == SLSTM:
                return rec.SLSTMState(P(b, m), P(b, m), P(b, m), P(b, m))
            if spec.mixer == RGLRU:
                return rec.RGLRUState(P(b, m), P(b, None, m))
            raise ValueError(spec.mixer)

        specs = [one(s) for s in cfg.effective_layout(serve_long)]
        if shapes is None:
            from repro_torch.models.model import init_cache
            shapes = _shapes(lambda: init_cache(cfg, batch, max_len, "cpu"))
        return tree_map(lambda sp, sh: _guard(sp, sh.shape, self.mesh),
                        specs, shapes, is_leaf=_is_spec)

    def batch_spec(self, extra_dims: int = 1) -> P:
        dp = self.dp
        b = dp if len(dp) > 1 else (dp[0] if dp else None)
        return P(b, *([None] * extra_dims))

    def opt(self, param_specs):
        """Specs of ``training.optimizer.AdamWState``: the step count
        replicated, each moment leaf as its param (in the order
        ``training.tree.flatten`` gives the params)."""
        from repro_torch.training import tree
        from repro_torch.training.optimizer import AdamWState
        leaves = tree.flatten(param_specs)[0]
        return AdamWState(P(), list(leaves), list(leaves))


# ------------------------------------------------------------- shards

def shard(t: torch.Tensor, spec: P, mesh, coords=None) -> torch.Tensor:
    """The piece of ``t`` that the rank at ``coords`` (this rank's by
    default) holds under ``spec``: each sharded dimension cut into its
    axes' extent, the rank's block taken (several axes on one dimension
    split it in their order, major first). A contiguous copy."""
    coords = mesh.coords if coords is None else coords
    out = t
    for dim, names in enumerate(spec):
        if names is None:
            continue
        ns = names if isinstance(names, tuple) else (names,)
        n, idx = 1, 0
        for a in ns:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        size = t.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.contiguous()


def shard_tree(tree, specs, mesh, coords=None):
    """``shard`` over a tree of tensors and its specs."""
    return tree_map(lambda t, s: shard(t, s, mesh, coords), tree, specs)
