"""DecodeExecutor: the placement layer between the decode path and a mesh
of ranks, the PyTorch counterpart of ``repro.serving.executor``.

Everything above this module (``DiffusionDecoder``, ``BlockScheduler``,
``PrefixKVPool``, the engines) keeps *host arrays of every row*;
everything below it (the block programs, the kernels) sees *this rank's
tensors*. The port is SPMD (``launch.mesh``): every rank of the mesh
runs the same scheduler on the same requests, so the host arrays and
every decision are the same on each, and the executor owns the
boundary:

* **param placement**: each rank keeps its shard of every weight, cut
  by ``launch.sharding.SpecBuilder``'s serve-mode specs (the model axis
  is tensor parallel: attention heads, d_ff, experts' hidden width,
  vocab; MoE experts over data).
* **cache placement**: KV buffers and recurrent states are created at
  the shard's shapes (batch over the data axes, heads over model),
  never whole first.
* **gang rows**: a gang's rows are split over the data axes when the
  gang batch divides their extent, and *replicated* when it does not
  (never silently padded; the scheduler rounds gang sizes to the
  extent, so the fallback is rare). ``rows`` is this rank's part.
* **gather**: what a block hands back to the host (tokens, commit
  masks, counters) is gathered over the data line in one collective
  (``gather_block``) before the block's one host sync.

``executor=None`` everywhere above this layer is the single-device path.
The placement *key* tags pool buffers and prefix stores so a buffer
placed on one mesh never reaches a decoder driving another; the *shape
key* keys a store shared by executors whose chunk KV is byte-identical
(the same mesh shape on the same kind of device).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import data_axes_of
from repro_torch.launch.sharding import (P, SpecBuilder, _extent, _shapes,
                                         shard, shard_tree)
from repro_torch.models.config import ATTN, ATTN_LOCAL, ModelConfig
from repro_torch.models.heads import plan_heads
from repro_torch.models.model import init_cache, params_to


class DecodeExecutor:
    """Owns one mesh on this rank: placed params, sharded cache creation
    and the row split of gang-shaped arrays. ``device``: where this
    rank's tensors live (cuda unless named)."""

    def __init__(self, cfg: ModelConfig, params, mesh, *, device=None):
        from repro_torch.device import resolve_device
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is not in {mesh}: only the "
                             "mesh's ranks place its params")
        n_model = mesh.shape.get("model", 1)
        plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
        if any(s.mixer in (ATTN, ATTN_LOCAL) for s in cfg.layout) and \
                (plan.pad_q % n_model == 0) != (plan.pad_kv % n_model == 0):
            raise ValueError(
                f"{cfg.name}: {plan.pad_q} q heads over {plan.pad_kv} kv "
                f"heads do not split alike over model={n_model}; build the "
                f"config with tp={n_model} (heads.plan_heads pads them)")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.data_axes: Tuple[str, ...] = data_axes_of(mesh)
        self.data_extent = 1
        for a in self.data_axes:
            self.data_extent *= mesh.shape[a]
        self.data = mesh.group(self.data_axes)
        self.model = mesh.model_group
        self._sb = SpecBuilder(cfg, mesh, mode="serve")
        self._dp = (self.data_axes if len(self.data_axes) > 1
                    else (self.data_axes[0] if self.data_axes else None))
        self.param_specs = self._sb.params(shapes=params)
        self.params = params_to(shard_tree(params, self.param_specs, mesh),
                                self.device)
        self._cache_specs: Dict[Tuple[int, int], list] = {}
        self._decoders: list = []

    # ------------------------------------------------------ identity

    @property
    def placement(self) -> tuple:
        """Hashable placement key: which ranks this mesh spans (and the
        kind of device they decode on). Pool buffers and prefix stores
        are bucketed by it so meshes never share buffers."""
        return ("mesh", self.device.type) + tuple(
            sorted(int(r) for r in self.mesh.devices.flat))

    @property
    def shape_key(self) -> tuple:
        """Hashable mesh-*shape* key. KV numerics depend on the mesh
        shape (the reduction order of sharded products, head padding)
        and the kind of device, not on which ranks back it: a *shared*
        ``PrefixKVCache`` is keyed by this."""
        return ("shape", self.device.type) + tuple(
            sorted(self.mesh.shape.items()))

    def __repr__(self):
        return (f"DecodeExecutor(mesh={self.mesh.shape}, "
                f"ranks={self.placement[2:]})")

    # ------------------------------------------------------ rows

    def splits(self, batch: int) -> bool:
        """Whether a gang of ``batch`` rows is split over the data axes
        (else every rank holds every row)."""
        return self.data_extent > 1 and batch % self.data_extent == 0

    def batch_sharding(self, ndim: int, batch: int) -> P:
        """Data-axis spec over dim 0 when the batch divides the data
        extent; replicated otherwise (never silent padding)."""
        if self.splits(batch):
            return P(self._dp, *([None] * (ndim - 1)))
        return P(*([None] * ndim))

    def rows(self, batch: int) -> slice:
        """This rank's rows of a gang of ``batch``."""
        if not self.splits(batch):
            return slice(0, batch)
        n = batch // self.data_extent
        return slice(self.data.index * n, (self.data.index + 1) * n)

    def local_batch(self, batch: int) -> int:
        r = self.rows(batch)
        return r.stop - r.start

    def put_batch(self, arr) -> torch.Tensor:
        """Upload this rank's rows of one gang-shaped host array (dim 0 =
        batch)."""
        arr = np.asarray(arr)
        return torch.tensor(np.ascontiguousarray(arr[self.rows(
            arr.shape[0])]), device=self.device)

    def gather_rows(self, t: torch.Tensor, batch: int) -> torch.Tensor:
        """Every row of a gang of ``batch`` from this rank's (dim 0)."""
        return self.data.all_gather(t, 0) if self.splits(batch) else t

    def gather_block(self, outs: Dict[str, torch.Tensor], batch: int,
                     row_keys, sum_keys) -> Dict[str, np.ndarray]:
        """A block's outputs to the host in one collective over the data
        line: each tensor flattened into one int32 buffer (floats by
        their bits), gathered, then unpacked on the host. ``row_keys``
        have the batch on dim 0 (concatenated in rank order where the
        rows are split), ``sum_keys`` are counters summed over the ranks
        where they are split; the rest are the same on every rank. The
        copy to host memory is the block's one sync."""
        names = list(outs)
        flat = []
        for n in names:
            t = outs[n]
            if t.dtype == torch.float32:
                t = t.view(torch.int32)
            flat.append(t.reshape(-1).to(torch.int32))
        packed = torch.cat(flat)
        split = self.splits(batch)
        if self.data.active:
            packed = self.data.all_gather(packed[None], 0)
        else:
            packed = packed[None]
        host = packed.cpu().numpy()
        out: Dict[str, np.ndarray] = {}
        off = 0
        for n, f in zip(names, flat):
            t = outs[n]
            cols = host[:, off:off + f.numel()]
            off += f.numel()
            if t.dtype == torch.float32:
                cols = cols.view(np.float32)
            elif t.dtype == torch.bool:
                cols = cols.astype(bool)
            parts = cols.reshape((-1,) + tuple(t.shape))
            if split and n in row_keys:
                out[n] = np.concatenate(list(parts))
            elif split and n in sum_keys:
                out[n] = parts.sum(axis=0).astype(parts.dtype)
            else:
                out[n] = parts[0].copy()
        return out

    # ------------------------------------------------------ caches

    def cache_specs(self, batch: int, total_len: int) -> list:
        key = (batch, total_len)
        if key not in self._cache_specs:
            self._cache_specs[key] = self._sb.cache(batch, total_len)
        return self._cache_specs[key]

    def init_cache(self, batch: int, total_len: int):
        """This rank's shard of an empty cache of (batch, total_len):
        one row of the whole cache is made, cut to the shard's non-batch
        widths and repeated to this rank's rows, so the whole cache never
        exists."""
        specs = self.cache_specs(batch, total_len)
        one = init_cache(self.cfg, 1, total_len, self.device)
        n = self.local_batch(batch)

        def place(t, spec):
            piece = shard(t, P(None, *tuple(spec)[1:]), self.mesh)
            return piece.expand(n, *piece.shape[1:]).contiguous()
        return _zip_cache(place, one, specs)

    def constrain_cache(self, cache, batch: int, total_len: int):
        """Check that a cache holds this rank's shard of (batch,
        total_len) (a pool buffer recycled across gangs must be one);
        returns it."""
        if not cache:
            return cache
        want = self._shard_shapes(batch, total_len)
        got = [tuple(t.shape) for layer in cache for t in layer]
        if got != want:
            raise ValueError(f"cache shard shapes {got} != {want} for "
                             f"({batch}, {total_len}) on {self}")
        return cache

    def _shard_shapes(self, batch: int, total_len: int) -> list:
        specs = self.cache_specs(batch, total_len)
        full = _shapes(lambda: init_cache(self.cfg, batch, total_len, "cpu"))
        out = []
        for layer, lspecs in zip(full, specs):
            for t, spec in zip(layer, lspecs):
                shape = list(t.shape)
                for i, names in enumerate(spec):
                    if names is not None:
                        shape[i] //= _extent(names, self.mesh)
                out.append(tuple(shape))
        return out

    def gather_cache(self, cache, batch: int):
        """Every row of a gang's cache from this rank's shard rows."""
        if not self.splits(batch):
            return cache
        return [type(layer)(*(self.data.all_gather(t, 0) for t in layer))
                if hasattr(layer, "_fields") else
                tuple(self.data.all_gather(t, 0) for t in layer)
                for layer in cache]

    def local_cache(self, cache, batch: int):
        """This rank's rows of a cache that holds every row (a copy)."""
        r = self.rows(batch)
        return [type(layer)(*(t[r].contiguous() for t in layer))
                if hasattr(layer, "_fields") else
                tuple(t[r].contiguous() for t in layer) for layer in cache]

    # ------------------------------------------------------ graphs

    def attach(self, decoder) -> None:
        """Count ``decoder``'s block programs in ``graph_cache_size``."""
        self._decoders.append(decoder)

    def detach(self, decoder) -> None:
        """Stop counting ``decoder``'s block programs here."""
        self._decoders.remove(decoder)

    def graph_cache_size(self) -> int:
        """Block programs (on the card, captured CUDA graphs) built by the
        decoders that drive this executor: where the JAX executor counts
        its compiled cache-creation variants (``jit_cache_size``), since
        the port's caches are made eagerly and its compiled artifacts are
        the graphs."""
        return sum(d.graph_cache_size() for d in self._decoders)


def _zip_cache(fn, cache, specs):
    out = []
    for layer, lspecs in zip(cache, specs):
        leaves = [fn(t, s) for t, s in zip(layer, lspecs)]
        out.append(type(layer)(*leaves) if hasattr(layer, "_fields")
                   else tuple(leaves))
    return out

