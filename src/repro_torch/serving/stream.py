"""Streaming output path: per-block callbacks and pull iterators (copy
of ``repro.serving.stream``).

The scheduler emits ``BlockChunk``s at every block boundary; this
module routes them. Two consumption styles:

* callbacks — ``router.subscribe(uid, fn)`` (or ``uid=None`` for a
  wildcard) fires ``fn(chunk)`` synchronously as chunks are published;
* iterators — ``RequestStream`` buffers one request's chunks and is
  drained by iterating while the engine ticks.

Chunks for a given request always arrive in block order (the scheduler
advances a request's gang one block per tick), so consumers can
concatenate ``chunk.text`` pieces directly.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.serving.types import BlockChunk

log = logging.getLogger(__name__)


class StreamRouter:
    """Chunk fan-out. A subscriber that raises is logged and dropped —
    one broken consumer must not abort delivery to the rest of the
    batch — and emptied subscriber lists (per-uid *and* wildcard) are
    garbage-collected so a long-lived engine doesn't accumulate dead
    keys from every request it ever served."""

    def __init__(self):
        self._subs: Dict[Optional[int], List[Callable[[BlockChunk], None]]] \
            = {}

    def subscribe(self, uid: Optional[int],
                  fn: Callable[[BlockChunk], None]) -> None:
        """``uid=None`` subscribes to every request's chunks."""
        self._subs.setdefault(uid, []).append(fn)

    def unsubscribe(self, uid: Optional[int],
                    fn: Callable[[BlockChunk], None]) -> None:
        subs = self._subs.get(uid)
        if subs and fn in subs:
            subs.remove(fn)
        if subs is not None and not subs:
            del self._subs[uid]

    def _deliver(self, key: Optional[int], chunk: BlockChunk) -> None:
        subs = self._subs.get(key)
        if not subs:
            return
        for fn in list(subs):
            try:
                fn(chunk)
            except Exception:
                log.exception("stream subscriber for uid=%s raised; "
                              "unsubscribing it", key)
                try:
                    subs.remove(fn)
                except ValueError:
                    pass
        if not subs:
            self._subs.pop(key, None)

    def publish(self, chunks: List[BlockChunk]) -> None:
        for chunk in chunks:
            self._deliver(chunk.uid, chunk)
            self._deliver(None, chunk)
            # drop per-uid subscribers once their request finished
            if chunk.finished:
                self._subs.pop(chunk.uid, None)


class RequestStream:
    """Buffered per-request chunk stream. Fed by a router subscription;
    drained with ``next()`` / iteration while the engine is stepped (the
    engine's ``stream()`` drives ticking for you)."""

    def __init__(self, router: StreamRouter, uid: int):
        self.uid = uid
        self._buf: Deque[BlockChunk] = deque()
        self._finished = False
        router.subscribe(uid, self._on_chunk)

    def _on_chunk(self, chunk: BlockChunk) -> None:
        self._buf.append(chunk)
        self._finished |= chunk.finished

    @property
    def exhausted(self) -> bool:
        return self._finished and not self._buf

    def pop(self) -> Optional[BlockChunk]:
        return self._buf.popleft() if self._buf else None

    def drain(self) -> List[BlockChunk]:
        out = list(self._buf)
        self._buf.clear()
        return out

    @property
    def text(self) -> str:
        raise AttributeError("RequestStream buffers chunks; join "
                             "chunk.text pieces as you drain them")
