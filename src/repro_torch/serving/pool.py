"""Shape- and placement-bucketed KV-cache buffer pool (the PyTorch
counterpart of ``repro.serving.pool``).

Buffers are keyed by ``(batch, total_len, placement)``. Only the
single-device placement exists (``HOST_PLACEMENT``); placement across
cards (the JAX package's ``DecodeExecutor``) is ROADMAP A11.

Which states draw from the pool — the graph binding rule
(``repro_torch.core.decoder``): on the card a block graph bakes in
buffer addresses, so the decoder owns one KV buffer per (B, T), the
*bound* buffer, and every graph of that shape reads and writes it. For
most states the block refresh rewrites every slot the steps read, so
they run on the bound buffer and need no buffer of their own: the
scheduler never acquires from the pool for them, and never releases a
bound buffer into it. A dkv state, and a prefix-cached state (its prompt
KV is computed at prefill, never refreshed), carries its cache across
blocks (``DiffusionDecoder.cache_carries_state``), so it owns a buffer —
the pool's — that the device loop copies into the bound buffer before
each replay and back after. The pool therefore serves those gangs (their
prefill and a resumed state's re-prime) and counts it:
``hits``/``misses`` stay zero for a scheduler of any other state.

Buffers are retained on a bounded free list with oldest-first
eviction.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache

HOST_PLACEMENT = ("host",)    # the single-device world


class PrefixKVPool:
    def __init__(self, cfg: ModelConfig, max_free: int = 8, executor=None,
                 device=None):
        if executor is not None:
            raise NotImplementedError(
                "executor placement is ROADMAP A11")
        self.cfg = cfg
        self.max_free = max_free
        self.device = resolve_device(device)
        self.placement: Tuple = HOST_PLACEMENT
        self._free: List[Tuple[int, tuple, Any]] = []
        self._seq = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _key(self, batch: int, total_len: int) -> tuple:
        return (batch, total_len, self.placement)

    def acquire(self, batch: int, total_len: int):
        """Return a cache for the bucket, reusing the most recently
        released matching buffer when one exists."""
        key = self._key(batch, total_len)
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i][1] == key:
                _, _, cache = self._free.pop(i)
                self.hits += 1
                return cache
        self.misses += 1
        return init_cache(self.cfg, batch, total_len, self.device)

    def release(self, batch: int, total_len: int, cache) -> None:
        if cache is None:
            return
        self._seq += 1
        self._free.append((self._seq, self._key(batch, total_len), cache))
        while len(self._free) > self.max_free:
            self._free.pop(0)
            self.evictions += 1

    @property
    def free_buffers(self) -> int:
        return len(self._free)

    def free_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for _, _, cache in self._free
                   for kv in cache for t in kv)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "free_buffers": len(self._free),
                "free_bytes": self.free_bytes()}
