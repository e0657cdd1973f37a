"""Hash-chained radix tree over fixed-size prompt token chunks.

The tree indexes prompt *content*: level ``i`` holds the i-th chunk of
``chunk_tokens`` prompt ids, and a node's identity is the hash chain
``H(parent_id || chunk_bytes)`` — equal prefixes collide into one node
no matter which request inserted them, and a node's payload (the KV
slice attached by ``repro_torch.cache.store``) is valid for *every* request
whose prompt starts with that chunk chain. Matching walks from the
root consuming whole chunks; the unaligned remainder of a prompt is
never indexed (it is recomputed per request — see the decoder's
chunk-aligned prefill).

Eviction is leaf-only LRU with refcount pinning: an interior node is
by construction older than its children (chains are inserted root to
leaf), so evicting leaves first preserves the invariant that every
stored chain is contiguous from the root — a partial chain with a hole
could never be assembled into a prefill. Pinned nodes (``refs > 0``)
are skipped: a scheduler that matched a chain holds it pinned until
the KV copy into the gang buffer is done, so eviction pressure can
never free bytes mid-assembly.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np


def chunk_key(tokens: np.ndarray) -> bytes:
    """Canonical dict key for one chunk of token ids."""
    return np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()


class ChunkNode:
    """One chunk of one cached prompt prefix. ``payload`` is opaque to
    the tree (the store attaches per-layer KV slices); ``nbytes`` is
    accounted by the store at insert time."""

    __slots__ = ("node_id", "parent", "key", "tokens", "payload",
                 "nbytes", "children", "refs", "stamp")

    def __init__(self, parent: Optional["ChunkNode"], tokens: np.ndarray,
                 payload, nbytes: int, stamp: int):
        self.parent = parent
        self.key = chunk_key(tokens)
        parent_id = parent.node_id if parent is not None else b"root"
        self.node_id = hashlib.blake2b(
            parent_id + self.key, digest_size=16).digest()
        self.tokens = np.asarray(tokens, np.int32).copy()
        self.payload = payload
        self.nbytes = nbytes
        self.children: Dict[bytes, "ChunkNode"] = {}
        self.refs = 0
        self.stamp = stamp

    @property
    def depth(self) -> int:
        """Chunks in the prefix this node terminates (self-inclusive)."""
        d, n = 1, self.parent
        while n is not None:
            d, n = d + 1, n.parent
        return d


class RadixTree:
    def __init__(self, chunk_tokens: int):
        assert chunk_tokens > 0
        self.chunk_tokens = chunk_tokens
        self.root_children: Dict[bytes, ChunkNode] = {}
        self.nodes: set = set()          # all live ChunkNodes (O(1) remove)
        self._stamp = 0

    def __len__(self) -> int:
        return len(self.nodes)

    def _tick(self) -> int:
        self._stamp += 1
        return self._stamp

    def _children_of(self, node: Optional[ChunkNode]) -> Dict[bytes,
                                                              ChunkNode]:
        return self.root_children if node is None else node.children

    # ------------------------------------------------------ lookup

    def walk(self, tokens: np.ndarray, *, touch: bool = False) \
            -> List[ChunkNode]:
        """Longest chunk-aligned cached prefix of ``tokens``: the node
        chain root→leafward. ``touch`` refreshes LRU stamps."""
        tokens = np.asarray(tokens, np.int32)
        C = self.chunk_tokens
        chain: List[ChunkNode] = []
        node: Optional[ChunkNode] = None
        for c in range(len(tokens) // C):
            child = self._children_of(node).get(
                chunk_key(tokens[c * C:(c + 1) * C]))
            if child is None:
                break
            if touch:
                child.stamp = self._tick()
            chain.append(child)
            node = child
        return chain

    def match_tokens(self, tokens: np.ndarray) -> int:
        """Length (in tokens) of the longest cached prefix. Pure read —
        no pin, no LRU touch; safe as a cross-thread routing heuristic."""
        return len(self.walk(tokens)) * self.chunk_tokens

    # ------------------------------------------------------ mutation

    def extend(self, parent: Optional[ChunkNode], tokens: np.ndarray,
               payload, nbytes: int) -> ChunkNode:
        """Add (or return the existing) child of ``parent`` for one
        chunk. An existing node keeps its payload — two rows of one
        gang inserting the same template must not double-store."""
        siblings = self._children_of(parent)
        key = chunk_key(tokens)
        node = siblings.get(key)
        if node is not None:
            node.stamp = self._tick()
            return node
        node = ChunkNode(parent, tokens, payload, nbytes, self._tick())
        siblings[key] = node
        self.nodes.add(node)
        return node

    def remove(self, node: ChunkNode) -> None:
        assert not node.children, "only leaves are evictable"
        self._children_of(node.parent).pop(node.key, None)
        self.nodes.discard(node)

    def evictable_leaves(self) -> List[ChunkNode]:
        """Unpinned leaves, oldest stamp first (the LRU eviction
        frontier)."""
        leaves = [n for n in self.nodes if not n.children and n.refs == 0]
        leaves.sort(key=lambda n: n.stamp)
        return leaves
