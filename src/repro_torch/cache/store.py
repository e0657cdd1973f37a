"""Cross-request prefix KV cache: content-addressed chunk store (the
PyTorch counterpart of ``repro.cache.store``).

``PrefixKVCache`` maps *prompt content* to prefill KV: prompt token
ids are chunked into ``chunk_tokens`` blocks, indexed in a
hash-chained radix tree (``repro_torch.cache.radix``), and each node carries
the per-layer KV slice the chunk-aligned prefill pass computed for it.
Because the cached prefill is chunk-causal (chunk *i* attends to
chunks ``0..i`` only — see ``DiffusionDecoder.prime_prompt_kv``), a
chunk's KV depends on nothing but the tokens up to and including it,
which is exactly what the radix chain addresses — so a slice computed
for one request is byte-valid for every other request sharing the
prefix, across gen-length buckets and across decode methods.

Placement: KV numerics depend on where a chunk was computed (the CPU's
and the card's sums run in other orders), so a store is keyed by the
device it serves (``device_placement``), like ``PrefixKVPool``: the
scheduler refuses a store bound elsewhere. Placement across cards (the
JAX package's executor) is ROADMAP A11.

Sharing: ``shared=True`` turns on internal locking, for several engine
threads that match, insert and evict concurrently (pins protect chunks
across multi-call spans, the lock protects the tree within each call).
The disaggregated prefill/decode pools that share one store are ROADMAP
A10.

Eviction: ref-counted LRU over leaf chunks with a byte budget
(``max_bytes``). ``match`` pins the returned chain; the caller unpins
after assembling the KV into its gang buffer, so chunks in active use
are never freed. Slices live as host (CPU) tensors — byte copies of the
device cache, pinned when it lies on the card (``repro_torch.cache.
slicing``); host staging keeps the store off the card's memory budget.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.cache.radix import ChunkNode, RadixTree

HOST_PLACEMENT = ("host",)    # mirrors repro_torch.serving.pool


def device_placement(device) -> Tuple:
    """The placement key of a store that serves ``device``: the single-
    device world of the pool, and the device type (chunk KV computed on
    the CPU and on the card differ in their last bits)."""
    return (*HOST_PLACEMENT, torch.device(device).type)


class PrefixKVCache:
    def __init__(self, chunk_tokens: int = 16,
                 max_bytes: int = 256 << 20,
                 placement: Tuple = HOST_PLACEMENT,
                 shared: bool = False):
        self.chunk_tokens = chunk_tokens
        self.max_bytes = max_bytes
        self.placement = tuple(placement)
        self.shared = shared
        # single-engine stores are touched only by that engine's decode
        # thread (plus lock-free match_len probes) — no lock overhead
        self._lock = (threading.RLock() if shared
                      else contextlib.nullcontext())
        self.tree = RadixTree(chunk_tokens)
        self.bytes = 0
        self.evictions = 0
        self.inserts = 0
        self.lookups = 0
        self.lookup_hits = 0
        self.lookup_hit_tokens = 0

    def __repr__(self):
        return (f"PrefixKVCache(chunk={self.chunk_tokens}, "
                f"nodes={len(self.tree)}, bytes={self.bytes}, "
                f"placement={self.placement}, shared={self.shared})")

    # ------------------------------------------------------ lookup

    def match_len(self, prompt_tokens: np.ndarray) -> int:
        """Longest cached prefix in tokens. Pure read (no pin, no LRU
        touch, no counters) — the admission grouper and the router's
        affinity heuristic call this from other threads. A shared
        store locks so the walk never races a sibling's eviction."""
        with self._lock:
            return self.tree.match_tokens(prompt_tokens)

    def match(self, prompt_tokens: np.ndarray) -> List[ChunkNode]:
        """Longest cached prefix as a *pinned* node chain. The caller
        owns one reference per returned node and must ``unpin`` the
        chain once the KV has been copied out."""
        with self._lock:
            chain = self.tree.walk(prompt_tokens, touch=True)
            for node in chain:
                node.refs += 1
            self.lookups += 1
            if chain:
                self.lookup_hits += 1
                self.lookup_hit_tokens += len(chain) * self.chunk_tokens
            return chain

    def unpin(self, chain: Sequence[ChunkNode]) -> None:
        with self._lock:
            for node in chain:
                assert node.refs > 0
                node.refs -= 1

    # ------------------------------------------------------ mutation

    def insert(self, prompt_tokens: np.ndarray, start_chunk: int,
               chunk_kvs: List[dict],
               parent_chain: Optional[Sequence[ChunkNode]] = None) -> int:
        """Attach freshly computed chunk KV for chunks
        ``start_chunk .. start_chunk+len(chunk_kvs)`` of the prompt.
        The chain below ``start_chunk`` must already exist (it is the
        pinned match the prefill assembled or recomputed over);
        ``parent_chain`` skips re-walking it. Returns nodes created —
        an existing node (two gang rows sharing a template) is kept,
        never double-stored."""
        from repro_torch.cache.slicing import slice_nbytes
        tokens = np.asarray(prompt_tokens, np.int32)
        C = self.chunk_tokens
        with self._lock:
            if (parent_chain is not None
                    and len(parent_chain) >= start_chunk):
                chain = list(parent_chain[:start_chunk])
            else:
                chain = self.tree.walk(tokens)
                if len(chain) < start_chunk:
                    return 0  # parent chain evicted under us: give up
                chain = chain[:start_chunk]
            parent = chain[-1] if chain else None
            created = 0
            for i, kv in enumerate(chunk_kvs):
                c = start_chunk + i
                nb = slice_nbytes(kv)
                before = len(self.tree)
                parent = self.tree.extend(parent,
                                          tokens[c * C:(c + 1) * C],
                                          kv, nb)
                if len(self.tree) > before:
                    created += 1
                    self.bytes += nb
                    self.inserts += 1
            self._evict_to_budget()
            return created

    def _evict_to_budget(self) -> None:
        """Level-wise LRU sweep: consume one sorted leaf scan in stamp
        order, then rescan only if evictions exposed new leaves (their
        parents) and the budget is still blown — O(levels · n log n),
        not one full scan per evicted chunk."""
        while self.bytes > self.max_bytes:
            leaves = self.tree.evictable_leaves()
            if not leaves:
                return        # everything left is pinned (or interior)
            for victim in leaves:
                if self.bytes <= self.max_bytes:
                    return
                if victim.children:
                    continue  # a later sibling eviction can't re-leaf it;
                              # defensive only
                self.tree.remove(victim)
                self.bytes -= victim.nbytes
                self.evictions += 1

    # ------------------------------------------------------ reporting

    @property
    def nodes(self) -> int:
        return len(self.tree)

    def stats(self) -> dict:
        with self._lock:
            return {"nodes": len(self.tree), "bytes": self.bytes,
                    "chunk_tokens": self.chunk_tokens,
                    "max_bytes": self.max_bytes, "shared": self.shared,
                    "evictions": self.evictions, "inserts": self.inserts,
                    "lookups": self.lookups,
                    "lookup_hits": self.lookup_hits,
                    "lookup_hit_tokens": self.lookup_hit_tokens}
