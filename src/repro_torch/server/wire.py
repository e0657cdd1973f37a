"""Minimal HTTP/1.1 + SSE wire handling on raw asyncio streams (a copy of
``repro.server.wire``).

No dependency beyond the stdlib: the container policy forbids new
packages, and the subset of HTTP this server speaks (``Content-Length``
bodies in, fixed-length JSON or chunked SSE out) is small enough that
hand-rolling it is simpler than vendoring a framework.

Fixed-length responses honor HTTP/1.1 persistent connections
(``Connection: keep-alive``, the 1.1 default): per-request TCP setup
dominates small-prompt TTFB, so clients issuing many short completions
reuse one socket (``repro_torch.server.client.ClientSession``). Streaming
(SSE) responses stay ``Connection: close`` — the client's only way to
abandon a stream mid-flight is dropping the connection, and that
disconnect-as-cancel signal must stay unambiguous.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Dict, Optional, Union
from urllib.parse import unquote

from repro_torch.server.types import BadRequest

REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}

MAX_HEADER_BYTES = 16384
MAX_BODY_BYTES = 1 << 20


@dataclasses.dataclass
class HttpRequest:
    method: str
    path: str
    headers: Dict[str, str]            # keys lower-cased
    body: bytes
    version: str = "HTTP/1.1"
    query: str = ""                    # raw query string, no leading '?'

    def params(self) -> Dict[str, str]:
        """Query parameters (last value wins; bare keys map to '')."""
        out: Dict[str, str] = {}
        for part in self.query.split("&"):
            if not part:
                continue
            key, _, val = part.partition("=")
            out[unquote(key)] = unquote(val)
        return out

    @property
    def keep_alive(self) -> bool:
        """Persistent-connection semantics: 1.1 defaults to keep-alive
        unless the client says close; 1.0 requires an explicit opt-in."""
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn


async def read_request(reader: asyncio.StreamReader) \
        -> Optional[HttpRequest]:
    """Parse one request. Returns ``None`` on a cleanly closed
    connection before any bytes; raises ``BadRequest`` on malformed
    input (the caller maps it to a 4xx response)."""
    try:
        line = await reader.readline()
    except (ConnectionError, asyncio.IncompleteReadError):
        return None
    if not line:
        return None
    parts = line.decode("latin1").strip().split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise BadRequest("malformed request line")
    method, path, version = parts
    headers: Dict[str, str] = {}
    total = len(line)
    while True:
        h = await reader.readline()
        total += len(h)
        if total > MAX_HEADER_BYTES:
            raise BadRequest("headers too large")
        if h in (b"\r\n", b"\n", b""):
            break
        key, sep, val = h.decode("latin1").partition(":")
        if not sep:
            raise BadRequest("malformed header line")
        headers[key.strip().lower()] = val.strip()
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise BadRequest("bad Content-Length")
        if n > MAX_BODY_BYTES:
            raise BadRequest("body too large")
        if n:
            try:
                body = await reader.readexactly(n)
            except asyncio.IncompleteReadError:
                return None
    elif headers.get("transfer-encoding"):
        raise BadRequest("chunked request bodies are not supported")
    path, _, query = path.partition("?")
    return HttpRequest(method, path, headers, body, version, query=query)


def response(status: int, body: Union[bytes, dict, str] = b"",
             content_type: str = "application/json",
             extra_headers: Dict[str, str] = None,
             keep_alive: bool = False) -> bytes:
    """Fixed-length response, ready to write. ``keep_alive`` leaves the
    connection open for the client's next request (the Content-Length
    framing makes that safe); default remains close."""
    if isinstance(body, dict):
        body = (json.dumps(body) + "\n").encode()
    elif isinstance(body, str):
        body = body.encode()
    head = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin1") + body


def error_response(status: int, message: str,
                   extra_headers: Dict[str, str] = None,
                   keep_alive: bool = False) -> bytes:
    return response(status, {"error": message},
                    extra_headers=extra_headers, keep_alive=keep_alive)


def sse_header(extra_headers: Dict[str, str] = None) -> bytes:
    """Chunked SSE response head (``Connection: close`` — see module
    docstring) with optional extra headers (``X-Repro-Trace-Id``)."""
    head = ["HTTP/1.1 200 OK",
            "Content-Type: text/event-stream",
            "Cache-Control: no-cache",
            "Connection: close",
            "Transfer-Encoding: chunked"]
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin1")


SSE_HEADER = sse_header()

SSE_DONE_SENTINEL = "[DONE]"


def chunked(data: bytes) -> bytes:
    """One HTTP/1.1 chunked-transfer frame."""
    return f"{len(data):x}\r\n".encode("latin1") + data + b"\r\n"


CHUNKED_EOF = b"0\r\n\r\n"


def sse_event(payload: Union[dict, str]) -> bytes:
    """One SSE ``data:`` event, already wrapped in a chunked frame."""
    data = payload if isinstance(payload, str) else json.dumps(payload)
    return chunked(f"data: {data}\n\n".encode())


async def read_chunked(reader: asyncio.StreamReader):
    """Async generator over the data of a chunked response body
    (client side; used by the loopback client and the load harness)."""
    while True:
        size_line = await reader.readline()
        if not size_line:
            return
        n = int(size_line.strip() or b"0", 16)
        if n == 0:
            await reader.readline()      # trailing CRLF
            return
        data = await reader.readexactly(n)
        await reader.readexactly(2)      # chunk CRLF
        yield data
