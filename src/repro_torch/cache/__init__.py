"""Cross-request prefix KV cache (content-addressed, placement-aware):
the PyTorch counterpart of ``repro.cache``.

Layering:
    PrefixKVCache  — chunk store: radix-tree prompt matching, pinned
                     (ref-counted) LRU eviction under a byte budget,
                     keyed by the device it serves
    RadixTree      — hash-chained chunk index (``radix``)
    slicing        — KV-cache time-slice extract/assemble helpers

Consumed by ``DiffusionDecoder.prime_prompt_kv`` (chunk-aligned
prefill: assemble the longest cached prefix, compute only the novel
tail) and ``BlockScheduler`` (hit-aware admission grouping). Distinct
from ``repro_torch.serving.PrefixKVPool``, which recycles *buffers* by
shape; this store reuses *content*. The router's cache affinity is
ROADMAP A8/A10.
"""
from repro_torch.cache.radix import ChunkNode, RadixTree, chunk_key
from repro_torch.cache.slicing import (assemble_batch, assemble_rows,
                                       concat_chunks, extract_row,
                                       slice_nbytes, write_row)
from repro_torch.cache.store import (HOST_PLACEMENT, PrefixKVCache,
                                     device_placement)

__all__ = [
    "PrefixKVCache", "RadixTree", "ChunkNode", "chunk_key",
    "extract_row", "write_row", "concat_chunks", "assemble_rows",
    "assemble_batch", "slice_nbytes", "HOST_PLACEMENT", "device_placement",
]
