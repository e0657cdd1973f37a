"""Stdlib-only asyncio HTTP client for the port's server (a copy of
``repro.server.client``).

Exists so the test suite and the load harness can drive the server
over real sockets without external dependencies. Speaks exactly the
server's dialect: ``Content-Length`` JSON exchanges (one-shot
``Connection: close`` via ``request``/``complete``, or a persistent
keep-alive socket via ``ClientSession`` — per-request TCP setup
dominates small-prompt TTFB, so closed-loop clients should reuse their
connection), and chunked SSE for streams.
"""
from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, Dict, Optional, Tuple

from repro_torch.server import wire


def _request_bytes(method: str, path: str, host: str,
                   body: bytes = b"", keep_alive: bool = False) -> bytes:
    head = [f"{method} {path} HTTP/1.1",
            f"Host: {host}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    if body:
        head.append("Content-Type: application/json")
        head.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin1") + body


async def _read_head(reader: asyncio.StreamReader) \
        -> Tuple[int, Dict[str, str]]:
    status_line = await reader.readline()
    parts = status_line.split()
    if len(parts) < 2 or not parts[1].isdigit():
        # EOF or a torn partial line: the peer closed (or died on) the
        # possibly-stale keep-alive connection mid-response — surface a
        # connection error so ClientSession's reconnect retry fires,
        # never an IndexError from a half-flushed status line
        raise asyncio.IncompleteReadError(status_line, None)
    status = int(parts[1])
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        key, _, val = line.decode("latin1").partition(":")
        headers[key.strip().lower()] = val.strip()
    return status, headers


async def request(host: str, port: int, method: str, path: str,
                  payload: Optional[dict] = None) \
        -> Tuple[int, Dict[str, str], bytes]:
    """One fixed-length request/response exchange. Returns
    ``(status, headers, body)``."""
    body = json.dumps(payload).encode() if payload is not None else b""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_request_bytes(method, path, host, body))
        await writer.drain()
        status, headers = await _read_head(reader)
        n = int(headers.get("content-length", 0) or 0)
        resp = await reader.readexactly(n) if n else await reader.read()
        return status, headers, resp
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def complete(host: str, port: int, payload: dict) \
        -> Tuple[int, Dict[str, str], Optional[dict]]:
    """``POST /v1/completions`` with ``stream:false`` semantics."""
    status, headers, body = await request(
        host, port, "POST", "/v1/completions", payload)
    doc = json.loads(body) if body else None
    return status, headers, doc


class ClientSession:
    """A persistent keep-alive connection: many fixed-length exchanges
    over one socket. The server may close an idle session (its
    keep-alive timeout) — a send that hits a dead socket transparently
    reconnects once, so callers just keep issuing requests.

        sess = ClientSession(host, port)
        status, headers, doc = await sess.complete({...})
        ...
        await sess.close()
    """

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self.connects = 0          # sockets opened (1 = fully reused)
        self.requests = 0

    @property
    def connected(self) -> bool:
        return self._writer is not None and not self._writer.is_closing()

    async def _connect(self) -> None:
        await self.close()
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        self.connects += 1

    async def _exchange(self, data: bytes) -> Tuple[int, Dict[str, str],
                                                    bytes]:
        self._writer.write(data)
        await self._writer.drain()
        status, headers = await _read_head(self._reader)
        n = int(headers.get("content-length", 0) or 0)
        body = await self._reader.readexactly(n) if n else b""
        if headers.get("connection", "").lower() == "close":
            await self.close()     # server ended the session
        return status, headers, body

    async def request(self, method: str, path: str,
                      payload: Optional[dict] = None) \
            -> Tuple[int, Dict[str, str], bytes]:
        body = json.dumps(payload).encode() if payload is not None else b""
        data = _request_bytes(method, path, self.host, body,
                              keep_alive=True)
        if not self.connected:
            await self._connect()
        try:
            out = await self._exchange(data)
        except (ConnectionError, asyncio.IncompleteReadError):
            # stale keep-alive socket (server idle-timeout): retry once
            # on a fresh connection; a second failure is a real error
            await self._connect()
            out = await self._exchange(data)
        self.requests += 1
        return out

    async def complete(self, payload: dict) \
            -> Tuple[int, Dict[str, str], Optional[dict]]:
        status, headers, body = await self.request(
            "POST", "/v1/completions", payload)
        return status, headers, json.loads(body) if body else None

    async def close(self) -> None:
        w, self._reader, self._writer = self._writer, None, None
        if w is not None:
            w.close()
            try:
                await w.wait_closed()
            except (ConnectionError, OSError):
                pass


class SSEStream:
    """An open streaming completion. Iterate ``events()`` for parsed
    ``data:`` payloads (dicts; the ``[DONE]`` sentinel ends iteration);
    call ``abort()`` to drop the connection mid-stream — the server
    must treat that as a cancel."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, status: int,
                 headers: Dict[str, str]):
        self._reader = reader
        self._writer = writer
        self.status = status
        self.headers = headers
        self.error: Optional[dict] = None

    @classmethod
    async def open(cls, host: str, port: int, payload: dict) \
            -> "SSEStream":
        payload = dict(payload, stream=True)
        body = json.dumps(payload).encode()
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(_request_bytes("POST", "/v1/completions", host, body))
        await writer.drain()
        status, headers = await _read_head(reader)
        stream = cls(reader, writer, status, headers)
        if status != 200:
            n = int(headers.get("content-length", 0) or 0)
            raw = await reader.readexactly(n) if n else b""
            stream.error = json.loads(raw) if raw else None
            await stream.close()
        return stream

    async def events(self) -> AsyncIterator[dict]:
        buf = b""
        async for data in wire.read_chunked(self._reader):
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                for line in event.split(b"\n"):
                    if not line.startswith(b"data: "):
                        continue
                    text = line[len(b"data: "):].decode()
                    if text == wire.SSE_DONE_SENTINEL:
                        return
                    yield json.loads(text)

    def abort(self) -> None:
        """Hard-drop the connection (simulates a vanished client)."""
        self._writer.close()

    async def close(self) -> None:
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass
