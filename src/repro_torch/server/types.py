"""Network-facing request records and error types for ``repro_torch.server``
(a copy of ``repro.server.types``).

``ServerRequest`` is the wire-level request: what ``POST
/v1/completions`` accepts, plus the lifecycle fields the engine loop
acts on (deadline, priority). It is deliberately separate from
``repro_torch.serving.types.ServeRequest`` — that record is the scheduler's
internal bookkeeping; this one is the validated client contract.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


class ServerError(Exception):
    """Base for errors that map onto an HTTP status code."""
    status = 500
    reason = "Internal Server Error"

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class BadRequest(ServerError):
    status = 400
    reason = "Bad Request"


class AdmissionRejected(ServerError):
    """Bounded admission queue is full → HTTP 429 + ``Retry-After``."""
    status = 429
    reason = "Too Many Requests"

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class ServerRequest:
    """One validated completion request.

    ``timeout_s`` is a deadline measured from submission: if the
    request has not finished by then it is *cancelled* (partial result,
    ``finish_reason="deadline"``), never silently truncated or left
    running. ``priority`` is best-effort: higher values leave the
    front-end admission queue first, but once requests are handed to
    the scheduler they are gang-batched by shape, so priority orders
    admission, not execution."""
    prompt: str
    max_tokens: int = 64
    stream: bool = False
    timeout_s: Optional[float] = None
    priority: int = 0
    trace: bool = False         # echo the request's span events in the
                                # completion JSON (needs a live Tracer)

    MAX_TOKENS_CAP = 4096
    PROMPT_CAP = 65536

    @classmethod
    def from_json(cls, obj) -> "ServerRequest":
        if not isinstance(obj, dict):
            raise BadRequest("request body must be a JSON object")
        if "prompt" not in obj or not isinstance(obj["prompt"], str):
            raise BadRequest("'prompt' (string) is required")
        if len(obj["prompt"]) > cls.PROMPT_CAP:
            raise BadRequest(f"'prompt' longer than {cls.PROMPT_CAP} chars")
        if not obj["prompt"]:
            raise BadRequest("'prompt' must be non-empty")
        mt = obj.get("max_tokens", 64)
        if not isinstance(mt, int) or isinstance(mt, bool) \
                or not 1 <= mt <= cls.MAX_TOKENS_CAP:
            raise BadRequest(
                f"'max_tokens' must be an int in [1, {cls.MAX_TOKENS_CAP}]")
        stream = obj.get("stream", False)
        if not isinstance(stream, bool):
            raise BadRequest("'stream' must be a boolean")
        timeout_s = obj.get("timeout_s")
        if timeout_s is not None:
            if isinstance(timeout_s, bool) \
                    or not isinstance(timeout_s, (int, float)) \
                    or timeout_s <= 0:
                raise BadRequest("'timeout_s' must be a positive number")
            timeout_s = float(timeout_s)
        priority = obj.get("priority", 0)
        if not isinstance(priority, int) or isinstance(priority, bool):
            raise BadRequest("'priority' must be an int")
        trace = obj.get("trace", False)
        if not isinstance(trace, bool):
            raise BadRequest("'trace' must be a boolean")
        unknown = set(obj) - {"prompt", "max_tokens", "stream",
                              "timeout_s", "priority", "trace"}
        if unknown:
            raise BadRequest(f"unknown fields: {sorted(unknown)}")
        return cls(prompt=obj["prompt"], max_tokens=mt, stream=stream,
                   timeout_s=timeout_s, priority=priority, trace=trace)


def finish_reason(comp, cancel_reason: Optional[str]) -> str:
    """OpenAI-style terminal cause for a ``Completion``: ``stop`` (EOS),
    ``length`` (token budget exhausted), or the cancel cause
    (``cancelled`` / ``disconnect`` / ``deadline`` / ``shutdown``)."""
    if comp.cancelled:
        return cancel_reason or "cancelled"
    if comp.n_tokens < comp.max_tokens:
        return "stop"
    return "length"
