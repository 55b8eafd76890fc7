"""A small HTTP/1.1 client on asyncio streams: the load generator's
stand-in for aiohttp's ``ClientSession`` (the JAX package's load generator
is built on aiohttp; the port's runs where only the standard library, numpy
and torch are installed).

What it does, and no more:

- keep-alive connections reused through a pool per (host, port); ``limit``
  caps the connections open at once (``0``: no cap), as aiohttp's
  ``TCPConnector(limit=)`` does, and a request waits for a free one;
- ``Connection: close`` (and an HTTP/1.0 answer without keep-alive) closes
  the connection after the answer instead of pooling it;
- every request carries ``Content-Length`` (the port's server answers a
  chunked request body with 411);
- answers framed by ``Content-Length``, by ``Transfer-Encoding: chunked``
  (both servers' SSE streams) or by the end of the connection;
- a total timeout per request, head and body included, and an optional
  connect timeout per new connection (``connect_timeout_s``);
- ``open`` hands back an answer whose head has arrived with its connection
  held until ``release()`` (the router's stream relay reads the body at
  its own pace); the timeout then covers the head only;
- a refused, reset or timed-out connection, or a malformed answer, raises
  :class:`ClientError` (:class:`ClientTimeout` for the timeout) and closes
  that connection. Nothing is retried: the caller counts a failed request.

The hot path reuses request heads (cached per method, URL, headers and body
length), writes head and body with one ``writelines`` and reads a
``Content-Length`` body with one ``readexactly``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
from dataclasses import dataclass
from typing import AsyncIterator
from urllib.parse import urlsplit

_HEAD_LIMIT = 64 * 1024  # largest response head read (the server's limit too)
_CACHE_CAP = 4096        # request heads and parsed URLs kept per session
_READ_CHUNK = 64 * 1024


class ClientError(Exception):
    """A request that got no complete answer: the connection was refused,
    reset or closed early, or the answer was malformed."""


class ClientTimeout(ClientError):
    """The request's total timeout expired before the answer was complete."""


@dataclass
class Response:
    """A complete answer. ``headers`` has lower-cased names (repeated
    headers joined with ", ")."""

    status: int
    headers: dict
    body: bytes

    def json(self):
        return json.loads(self.body)


class _Conn:
    __slots__ = ("reader", "writer")

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer

    def close(self) -> None:
        self.writer.close()


def _parse_head(raw: bytes) -> tuple[str, int, dict]:
    lines = raw[:-4].decode("latin-1").split("\r\n")
    version, status, *_ = lines[0].split(" ", 2)
    if not version.startswith("HTTP/1."):
        raise ValueError(f"not an HTTP/1.x answer: {lines[0]!r}")
    headers: dict[str, str] = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"malformed header line {line!r}")
        name, value = name.strip().lower(), value.strip()
        headers[name] = f"{headers[name]}, {value}" if name in headers else value
    return version, int(status), headers


def _keep_alive(version: str, headers: dict) -> bool:
    conn = headers.get("connection", "").lower()
    if version == "HTTP/1.0":
        return "keep-alive" in conn
    return "close" not in conn


def _framing(method: str, status: int, headers: dict) -> tuple[str, int]:
    """How the body ends: ("none", 0), ("chunked", 0), ("length", n) or
    ("eof", 0)."""
    if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
        return "none", 0
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return "chunked", 0
    if "content-length" in headers:
        n = int(headers["content-length"])
        if n < 0:
            raise ValueError(f"negative Content-Length {n}")
        return "length", n
    return "eof", 0


async def _chunks(reader: asyncio.StreamReader) -> AsyncIterator[bytes]:
    """The data of a chunked body, one chunk at a time, trailers skipped."""
    while True:
        line = await reader.readuntil(b"\r\n")
        size = int(line.split(b";", 1)[0].strip(), 16)
        if size == 0:
            while await reader.readuntil(b"\r\n") != b"\r\n":
                pass  # trailer fields
            return
        data = await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise ValueError("chunk not followed by CRLF")
        yield data


# What a dead or misbehaving peer raises from the stream calls.
_TRANSPORT_ERRORS = (OSError, EOFError, asyncio.LimitOverrunError, ValueError)


class StreamResponse:
    """An answer whose head has arrived; its body is read by ``iter_any``
    (as it arrives) or ``read`` (whole). ``release()`` hands the connection
    back: to the pool after a complete body, closed otherwise (a body not
    read to its end tells the server the client went away)."""

    def __init__(self, status: int, headers: dict, reader: asyncio.StreamReader,
                 framing: tuple[str, int], on_release=None) -> None:
        self.status = status
        self.headers = headers
        self._reader = reader
        self._framing = framing
        self._on_release = on_release
        self.complete = framing[0] == "none"

    def release(self) -> None:
        """Return the connection (idempotent)."""
        if self._on_release is not None:
            on_release, self._on_release = self._on_release, None
            on_release(self)

    async def iter_any(self) -> AsyncIterator[bytes]:
        """Body bytes as they arrive (chunk boundaries are not meaningful)."""
        kind, n = self._framing
        reader = self._reader
        try:
            if kind == "chunked":
                async for data in _chunks(reader):
                    yield data
            elif kind == "length":
                while n > 0:
                    data = await reader.read(min(n, _READ_CHUNK))
                    if not data:
                        raise EOFError("connection closed inside the body")
                    n -= len(data)
                    yield data
            elif kind == "eof":
                while data := await reader.read(_READ_CHUNK):
                    yield data
        except _TRANSPORT_ERRORS as e:
            raise ClientError(f"answer body: {e!r}") from e
        self.complete = True

    async def read(self) -> bytes:
        """The whole body (a ``Content-Length`` one in one ``readexactly``)."""
        kind, n = self._framing
        if kind != "length":
            return b"".join([data async for data in self.iter_any()])
        try:
            body = await self._reader.readexactly(n)
        except _TRANSPORT_ERRORS as e:
            raise ClientError(f"answer body: {e!r}") from e
        self.complete = True
        return body


class ClientSession:
    """Pooled keep-alive HTTP/1.1 client for one event loop. ``limit``:
    most connections open at once (0 = no cap); ``timeout_s``: default total
    time per request (aiohttp's default is 300 s); ``connect_timeout_s``:
    the budget of opening a connection (a ClientError past it)."""

    def __init__(self, limit: int = 100, timeout_s: float = 300.0,
                 connect_timeout_s: float | None = None) -> None:
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self._slots = asyncio.Semaphore(limit) if limit > 0 else None
        self._idle: dict[tuple, list[_Conn]] = {}
        self._heads: dict[tuple, bytes] = {}
        self._urls: dict[str, tuple] = {}
        self._closed = False

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        self._closed = True
        for conns in self._idle.values():
            for conn in conns:
                conn.close()
        self._idle.clear()

    # -- the request head ----------------------------------------------------
    def _target(self, url: str) -> tuple:
        t = self._urls.get(url)
        if t is None:
            parts = urlsplit(url)
            if parts.scheme != "http" or not parts.hostname:
                raise ValueError(f"only http:// URLs are supported, got {url!r}")
            path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
            t = ((parts.hostname, parts.port or 80), parts.netloc, path)
            if len(self._urls) < _CACHE_CAP:
                self._urls[url] = t
        return t

    def _head(self, method: str, url: str, headers: dict | None, length: int) -> tuple:
        hdrs = tuple(headers.items()) if headers else ()
        key = (method, url, hdrs, length)
        head = self._heads.get(key)
        addr, netloc, path = self._target(url)
        if head is None:
            lines = [f"{method} {path} HTTP/1.1", f"Host: {netloc}"]
            lines += [f"{k}: {v}" for k, v in hdrs if k.lower() != "content-length"]
            lines.append(f"Content-Length: {length}")
            head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
            if len(self._heads) < _CACHE_CAP:
                self._heads[key] = head
        return addr, head

    # -- the pool --------------------------------------------------------------
    async def _acquire(self, addr: tuple) -> _Conn:
        if self._closed:
            raise ClientError("session is closed")
        if self._slots is not None:
            await self._slots.acquire()
        try:
            idle = self._idle.get(addr)
            while idle:
                conn = idle.pop()
                if not (conn.reader.at_eof() or conn.writer.is_closing()):
                    return conn
                conn.close()  # the peer closed it while idle
            return _Conn(*await asyncio.wait_for(
                asyncio.open_connection(*addr, limit=_HEAD_LIMIT), self.connect_timeout_s))
        except BaseException:
            self._release_slot()
            raise

    def _release_slot(self) -> None:
        if self._slots is not None:
            self._slots.release()

    def _release(self, addr: tuple, conn: _Conn, reusable: bool) -> None:
        if reusable and not self._closed:
            self._idle.setdefault(addr, []).append(conn)
        else:
            conn.close()
        self._release_slot()

    async def _exchange(self, method: str, url: str, data: bytes,
                        headers: dict | None) -> tuple:
        """Open or reuse a connection, send the request, read the answer's
        head: (addr, conn, version, status, headers, framing). On a failure
        the connection is closed and ClientError raised."""
        addr, head = self._head(method, url, headers, len(data))
        try:
            conn = await self._acquire(addr)
        except OSError as e:
            raise ClientError(f"{method} {url}: {e!r}") from e
        try:
            conn.writer.writelines((head, data) if data else (head,))
            await conn.writer.drain()
            version, status, hdrs = _parse_head(await conn.reader.readuntil(b"\r\n\r\n"))
            framing = _framing(method, status, hdrs)
        except BaseException as e:
            self._release(addr, conn, False)
            if isinstance(e, _TRANSPORT_ERRORS):
                raise ClientError(f"{method} {url}: {e!r}") from e
            raise
        return addr, conn, version, status, hdrs, framing

    # -- requests ------------------------------------------------------------
    async def _open(self, method: str, url: str, data: bytes,
                    headers: dict | None) -> StreamResponse:
        addr, conn, version, status, hdrs, framing = await self._exchange(
            method, url, data, headers)

        def on_release(resp: StreamResponse) -> None:
            self._release(addr, conn, resp.complete and framing[0] != "eof"
                          and _keep_alive(version, hdrs))

        return StreamResponse(status, hdrs, conn.reader, framing, on_release)

    async def open(self, method: str, url: str, data: bytes = b"",
                   headers: dict | None = None,
                   timeout_s: float | None = None) -> StreamResponse:
        """Send one request; return the answer once its head has arrived,
        its connection held until the caller's ``release()``. The timeout
        covers the head only."""
        try:
            async with asyncio.timeout(self.timeout_s if timeout_s is None else timeout_s):
                return await self._open(method, url, data, headers)
        except TimeoutError as e:
            raise ClientTimeout(f"{method} {url}: no answer in time") from e

    @contextlib.asynccontextmanager
    async def stream(self, method: str, url: str, data: bytes = b"",
                     headers: dict | None = None,
                     timeout_s: float | None = None) -> AsyncIterator[StreamResponse]:
        """Send one request; yields the answer once its head has arrived.
        The timeout covers the block too; a body not read to its end closes
        the connection instead of pooling it."""
        try:
            async with asyncio.timeout(self.timeout_s if timeout_s is None else timeout_s):
                resp = await self._open(method, url, data, headers)
                try:
                    yield resp
                finally:
                    resp.release()
        except TimeoutError as e:
            raise ClientTimeout(f"{method} {url}: no complete answer in time") from e

    async def request(self, method: str, url: str, data: bytes = b"",
                      headers: dict | None = None,
                      timeout_s: float | None = None) -> Response:
        """Send one request and read its whole answer."""
        async with self.stream(method, url, data, headers, timeout_s) as resp:
            body = await resp.read()
        return Response(resp.status, resp.headers, body)

    async def post(self, url: str, data: bytes = b"", headers: dict | None = None,
                   timeout_s: float | None = None) -> Response:
        return await self.request("POST", url, data, headers, timeout_s)

    async def get(self, url: str, headers: dict | None = None,
                  timeout_s: float | None = None) -> Response:
        return await self.request("GET", url, b"", headers, timeout_s)
