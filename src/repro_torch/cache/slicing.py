"""Time-axis slice helpers for the decoder's KV cache (the PyTorch
counterpart of ``repro.cache.slicing``).

The cache (``repro_torch.models.model.init_cache``) is a list with one
``(k, v)`` pair of ``(B, T, Hkv, D)`` buffers per layer. The prefix cache
stores *per-row, per-chunk* time slices of it: a list with one
``(k, v)`` pair of ``(span, Hkv, D)`` CPU tensors per layer, byte copies
of the device buffers (in their own dtype, bf16 included: no cast), so a
chunk assembled back into a gang buffer carries exactly the values the
original prefill pass wrote (the bit-identity the cached-prefill tests
assert). Slices of a card cache are pinned, so copying them back runs at
the link's rate.

Unlike the JAX package's functional helpers, ``write_row``,
``assemble_rows`` and ``assemble_batch`` write the buffers in place and
return the same cache list.

Only attention caches have a time axis; ``repro_torch.cache`` is gated to
attention-only layouts (the decoder asserts it).
"""
from __future__ import annotations

from typing import Dict, List

import torch


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` (pinned when ``t`` lies on the card); the copy
    has finished when this returns."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    out.copy_(t)
    return out


def extract_row(cache, row: int, t0: int, t1: int) -> List[tuple]:
    """One row's KV for time span [t0, t1) as host tensors (blocking
    device->host copies of the bytes)."""
    return [(_host_copy(k[row, t0:t1]), _host_copy(v[row, t0:t1]))
            for k, v in cache]


def write_row(cache, row: int, t0: int, kv):
    """Write a host KV slice back at [t0, t0+span) of one row, in place.
    Returns the cache."""
    for (k, v), (sk, sv) in zip(cache, kv):
        k[row, t0:t0 + sk.shape[0]].copy_(sk)
        v[row, t0:t0 + sv.shape[0]].copy_(sv)
    return cache


def concat_chunks(chunks: List[list]) -> List[tuple]:
    """Fuse consecutive chunk slices into one contiguous slice, so
    assembling a long cached prefix costs one device write per layer
    instead of one per chunk."""
    if len(chunks) == 1:
        return chunks[0]
    return [(torch.cat([c[i][0] for c in chunks]),
             torch.cat([c[i][1] for c in chunks]))
            for i in range(len(chunks[0]))]


def assemble_rows(cache, row_chunks: Dict[int, List[list]]):
    """Copy each row's cached chunk chain into the gang cache starting at
    time 0 (prompt region). ``row_chunks`` maps row index -> ordered chunk
    KV slices."""
    for row, chunks in row_chunks.items():
        if chunks:
            write_row(cache, row, 0, concat_chunks(chunks))
    return cache


def assemble_batch(cache, per_row_chunks: List[List[list]]):
    """Assembly for a whole gang at a common hit depth: every row gets the
    SAME number of chunks (its own content), so the per-row chains stack
    into one host tensor per leaf and land in ONE device write per leaf."""
    if not per_row_chunks or not per_row_chunks[0]:
        return cache
    assert len({len(c) for c in per_row_chunks}) == 1, \
        "assemble_batch wants a common chunk depth across rows"
    rows = [concat_chunks(chunks) for chunks in per_row_chunks]
    for i, (k, v) in enumerate(cache):
        for j, buf in enumerate((k, v)):
            stacked = torch.stack([r[i][j] for r in rows])   # (B, L, H, D)
            if buf.is_cuda:
                stacked = stacked.pin_memory()
            buf[:, :stacked.shape[1]].copy_(stacked)
    return cache


def slice_nbytes(kv) -> int:
    """Bytes of a chunk slice: every tensor of the nested list."""
    if isinstance(kv, torch.Tensor):
        return kv.numel() * kv.element_size()
    return sum(slice_nbytes(x) for x in kv)
