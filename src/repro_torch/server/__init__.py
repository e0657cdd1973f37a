"""Async network front end over the continuous batcher (the PyTorch
counterpart of ``repro.server``; every module here is a copy of the JAX
package's, which imports nothing of JAX).

Layering (top of the ``repro_torch.serving`` stack):

    HttpFrontend   — hand-rolled HTTP/1.1 + SSE on asyncio streams:
                     POST /v1/completions, GET /healthz, GET /metrics,
                     429 + Retry-After admission, graceful drain
    EngineRouter   — N EngineLoops (one per device/mesh) behind one
                     front end; least-loaded-by-live-rows placement,
                     cross-engine admission fallback
    EngineLoop     — the dedicated decode thread that owns
                     ``ContinuousEngine`` and the only thread-safe
                     submit/cancel surface; enforces deadlines
    ServerRequest  — validated wire request (max_tokens, stream,
                     timeout_s, priority)
    client         — stdlib loopback client for tests and
                     ``chip_smoke.py``

The split is deliberate: all device work and scheduler mutation happen
on one thread (no locks in the serving core), all network concurrency
lives in asyncio, and the two meet only through thread-safe queues. On
the card this makes the decode thread the only thread that runs CUDA
work (graph captures and replays, host copies): the front end's routes
read host-side counters only, so a scrape cannot break a capture.
"""
from repro_torch.server.http import HttpFrontend, run, serve
from repro_torch.server.loop import EngineLoop, Ticket
from repro_torch.server.router import EngineRouter
from repro_torch.server.types import (AdmissionRejected, BadRequest,
                                     ServerError, ServerRequest,
                                     finish_reason)

__all__ = [
    "HttpFrontend", "EngineLoop", "EngineRouter", "Ticket",
    "ServerRequest", "ServerError", "BadRequest", "AdmissionRejected",
    "finish_reason", "serve", "run",
]
