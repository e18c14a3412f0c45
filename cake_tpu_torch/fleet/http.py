"""Minimal HTTP/1.1 server and client on asyncio streams, for the router
tier (port-only: the reference's router, telemetry poller and tests are
aiohttp; the port's stay on the standard library, as its API server
does, so the router tier depends on no package at all).

The router's control flow stays the reference's: each request is a
coroutine, hedges are tasks, first-byte deadlines cancel in place and a
cancelled attempt closes its socket. This module gives it the few
pieces of aiohttp it used:

  * `App`: routes ("/api/v1/requests/{rid}" style patterns), startup /
    shutdown / cleanup hooks, `start(host, port)` on
    `asyncio.start_server`. One request per connection: every answer is
    sent with `Connection: close`.
  * `Request` (method, path, headers, body, match_info, json()),
    `Response` / `json_response` (a body with its Content-Length) and
    `StreamResponse` (prepare, write, write_eof; a close-delimited body,
    the shape a streamed answer takes here).
  * `request(method, url, ...)`: one outbound request, returning a
    `ClientResponse` once its status line and headers are in. Its body
    reads as Content-Length, chunked or close-delimited bytes (`read`,
    `iter_any`); a chunked or sized body cut short raises
    `IncompleteBody`.

Every transport failure is an OSError (ConnectionError among them), the
class the router already treats as "the replica never fully answered".
A close-delimited body cannot tell a cut from its end: the port's own
replicas answer HTTP/1.0 and close-delimit their SSE, so the router
reads an EOF before `data: [DONE]` as a break (router.py).
"""
from __future__ import annotations

import asyncio
import json
import logging
from urllib.parse import urlsplit

log = logging.getLogger("cake_tpu_torch.fleet.http")

__all__ = ["App", "Request", "Response", "StreamResponse", "json_response",
           "ClientResponse", "IncompleteBody", "request"]

# the longest request or status line and header block accepted
MAX_LINE = 64 * 1024
MAX_HEADERS = 100
READ_SIZE = 64 * 1024

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 429: "Too Many Requests",
            500: "Internal Server Error", 502: "Bad Gateway",
            503: "Service Unavailable", 504: "Gateway Timeout"}


class IncompleteBody(ConnectionError):
    """The peer closed inside a sized or chunked body."""


class Headers:
    """Case-insensitive header map that keeps the order and the case of
    what was set (the wire form)."""

    def __init__(self, items=None):
        self._items: list[tuple[str, str]] = []
        for k, v in (items.items() if isinstance(items, dict)
                     else items or ()):
            self[k] = v

    def __setitem__(self, name: str, value) -> None:
        low = name.lower()
        self._items = [(k, v) for k, v in self._items if k.lower() != low]
        self._items.append((name, str(value)))

    def add(self, name: str, value: str) -> None:
        self._items.append((name, value))

    def get(self, name: str, default=None):
        low = name.lower()
        for k, v in self._items:
            if k.lower() == low:
                return v
        return default

    def __getitem__(self, name: str) -> str:
        v = self.get(name)
        if v is None:
            raise KeyError(name)
        return v

    def __contains__(self, name: str) -> bool:
        return self.get(name) is not None

    def items(self):
        return list(self._items)


async def _read_head(reader: asyncio.StreamReader) -> tuple[str, Headers]:
    """(first line, headers) of a request or a response."""
    line = await reader.readline()
    if not line:
        raise ConnectionResetError("connection closed before a message")
    if len(line) > MAX_LINE:
        raise ConnectionError("message line too long")
    headers = Headers()
    for _ in range(MAX_HEADERS + 1):
        h = await reader.readline()
        if not h:
            raise IncompleteBody("connection closed inside the headers")
        if h in (b"\r\n", b"\n"):
            return line.decode("latin-1").rstrip("\r\n"), headers
        k, sep, v = h.decode("latin-1").partition(":")
        if not sep:
            raise ConnectionError(f"malformed header line {h[:80]!r}")
        headers.add(k.strip(), v.strip())
    raise ConnectionError("too many headers")


async def _body_pieces(reader: asyncio.StreamReader, headers: Headers):
    """The body's bytes as they arrive: chunked, sized, else up to EOF."""
    if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
        while True:
            line = await reader.readline()
            if not line.endswith(b"\n"):
                raise IncompleteBody("connection closed inside a chunked "
                                     "body")
            size = int(line.split(b";", 1)[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n",
                                                        b""):
                    pass            # trailers
                return
            left = size
            while left:
                piece = await reader.read(min(left, READ_SIZE))
                if not piece:
                    raise IncompleteBody("connection closed inside a "
                                         "chunk")
                left -= len(piece)
                yield piece
            if (await reader.readline()) not in (b"\r\n", b"\n"):
                raise IncompleteBody("chunk without its CRLF")
    elif headers.get("Content-Length") is not None:
        left = int(headers["Content-Length"])
        while left > 0:
            piece = await reader.read(min(left, READ_SIZE))
            if not piece:
                raise IncompleteBody(f"connection closed {left} bytes "
                                     "before the body's end")
            left -= len(piece)
            yield piece
    else:
        while True:
            piece = await reader.read(READ_SIZE)
            if not piece:
                return
            yield piece


def _content_type(headers: Headers) -> str:
    return (headers.get("Content-Type") or "").split(";", 1)[0].strip()


# -- server ------------------------------------------------------------------

class Request:
    """One parsed request (the body already read)."""

    def __init__(self, method: str, target: str, headers: Headers,
                 body: bytes, writer: asyncio.StreamWriter):
        self.method = method
        self.path = urlsplit(target).path
        self.headers = headers
        self.body = body
        self.writer = writer
        self.match_info: dict[str, str] = {}

    async def json(self):
        return json.loads(self.body or b"null")


def _head(status: int, headers: Headers) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A whole answer, sent with its Content-Length."""

    def __init__(self, body: bytes | str = b"", status: int = 200,
                 content_type: str = "application/json",
                 headers: dict | None = None):
        self.body = body.encode() if isinstance(body, str) else bytes(body)
        self.status = status
        self.headers = Headers(headers)
        if "Content-Type" not in self.headers:
            self.headers["Content-Type"] = content_type

    async def send(self, writer: asyncio.StreamWriter) -> None:
        self.headers["Content-Length"] = str(len(self.body))
        self.headers["Connection"] = "close"
        writer.write(_head(self.status, self.headers) + self.body)
        await writer.drain()


def json_response(obj, status: int = 200,
                  headers: dict | None = None) -> Response:
    return Response(json.dumps(obj).encode(), status, "application/json",
                    headers)


class StreamResponse:
    """An answer written as it is produced; its body ends when the
    connection closes (the server closes it once the handler returns)."""

    def __init__(self, status: int = 200, headers: dict | None = None):
        self.status = status
        self.headers = Headers(headers)
        self._writer: asyncio.StreamWriter | None = None
        self.prepared = False

    async def prepare(self, request: Request) -> None:
        self._writer = request.writer
        self.headers["Connection"] = "close"
        self.prepared = True
        await self._send(_head(self.status, self.headers))

    async def _send(self, data: bytes) -> None:
        w = self._writer
        if w.is_closing():
            raise ConnectionResetError("client connection closed")
        w.write(data)
        await w.drain()

    async def write(self, data: bytes) -> None:
        await self._send(data)

    async def write_eof(self) -> None:
        """Flush; the body ends when the server closes the connection,
        after the handler returns."""
        w = self._writer
        if w is not None and not w.is_closing():
            await w.drain()


async def _unless_client_leaves(aw, reader: asyncio.StreamReader):
    """Run a handler, cancelling it when the client closes its connection
    (EOF on a connection that carries one request), as aiohttp cancels a
    handler whose connection is lost: a router relaying for nobody stops
    at once, and closing its upstream socket cancels the replica's
    generation."""
    task = asyncio.ensure_future(aw)
    watch = asyncio.ensure_future(reader.read(1))
    try:
        done, _ = await asyncio.wait({task, watch},
                                     return_when=asyncio.FIRST_COMPLETED)
        if task not in done and (watch.exception() is not None
                                 or not watch.result()):
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            raise ConnectionResetError("client closed the connection")
        return await task
    finally:
        watch.cancel()
        if not task.done():
            task.cancel()


class App:
    """Routes plus lifecycle hooks, served by `start`."""

    def __init__(self):
        self._routes: list[tuple[str, list[str], object]] = []
        self.on_startup: list = []
        self.on_shutdown: list = []
        self.on_cleanup: list = []
        self._server: asyncio.base_events.Server | None = None
        self._conns: set = set()

    def add_get(self, pattern: str, handler) -> None:
        self._routes.append(("GET", pattern.strip("/").split("/"), handler))

    def add_post(self, pattern: str, handler) -> None:
        self._routes.append(("POST", pattern.strip("/").split("/"),
                             handler))

    def _match(self, method: str, path: str):
        parts = path.strip("/").split("/")
        allowed = False
        for m, pat, handler in self._routes:
            if len(pat) != len(parts):
                continue
            info = {}
            for p, v in zip(pat, parts):
                if p.startswith("{") and p.endswith("}") and v:
                    info[p[1:-1]] = v
                elif p != v:
                    break
            else:
                if m == method:
                    return handler, info
                allowed = True
        return None, 405 if allowed else 404

    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            line, headers = await _read_head(reader)
            method, target = line.split(" ")[:2]
            if (headers.get("Expect") or "").lower() == "100-continue":
                # curl asks before sending a body over 1 KB
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await writer.drain()
            body = b"".join([p async for p in _body_pieces(reader, headers)]
                            if (headers.get("Content-Length")
                                or headers.get("Transfer-Encoding"))
                            else [])
            req = Request(method.upper(), target, headers, body, writer)
            handler, info = self._match(req.method, req.path)
            if handler is None:
                resp = json_response({"error": "not found" if info == 404
                                      else "method not allowed"}, info)
            else:
                req.match_info = info
                resp = await _unless_client_leaves(handler(req), reader)
            if isinstance(resp, Response):
                await resp.send(writer)
            elif isinstance(resp, StreamResponse) and resp.prepared:
                await resp.write_eof()
        except (OSError, asyncio.IncompleteReadError, ValueError):
            pass                # the client went away or sent garbage
        except Exception:
            log.exception("handler failed")
            try:
                await json_response({"error": "internal error"},
                                    500).send(writer)
            except OSError:
                pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        """Run the startup hooks and listen; returns (host, port)."""
        for hook in self.on_startup:
            await hook(self)
        self._server = await asyncio.start_server(
            self._serve_conn, host, port, limit=MAX_LINE)
        return self._server.sockets[0].getsockname()[:2]

    async def stop(self) -> None:
        """Stop listening, run the shutdown hooks (the drain), end the
        connections still open, then the cleanup hooks."""
        if self._server is not None:
            self._server.close()
        for hook in self.on_shutdown:
            await hook(self)
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        for hook in self.on_cleanup:
            await hook(self)


# -- client ------------------------------------------------------------------

class ClientResponse:
    """An answer whose status line and headers are in; the body is read
    on demand. Use as an async context manager (closes the socket)."""

    def __init__(self, status: int, headers: Headers,
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.status = status
        self.headers = headers
        self.content_type = _content_type(headers)
        self._reader = reader
        self._writer = writer
        self._pieces = _body_pieces(reader, headers)
        # no length and no chunking: the body ends at EOF, so a cut
        # cannot be told from the end
        self.close_delimited = (
            headers.get("Content-Length") is None
            and "chunked" not in (headers.get("Transfer-Encoding")
                                  or "").lower())

    async def iter_any(self):
        async for piece in self._pieces:
            yield piece

    async def read(self) -> bytes:
        return b"".join([p async for p in self._pieces])

    def close(self) -> None:
        self._writer.close()

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()


async def request(method: str, url: str, *, json_body=None,
                  data: bytes | None = None, headers: dict | None = None,
                  connect_timeout: float | None = None) -> ClientResponse:
    """Send one request (HTTP/1.1, `Connection: close`) and wait for the
    answer's status line and headers. `connect_timeout` bounds the TCP
    handshake (asyncio.TimeoutError past it); the wait for the headers is
    the caller's to bound."""
    u = urlsplit(url)
    host, port = u.hostname, u.port or 80
    if json_body is not None:
        data = json.dumps(json_body).encode()
    conn = asyncio.open_connection(host, port, limit=MAX_LINE)
    if connect_timeout:
        reader, writer = await asyncio.wait_for(conn, connect_timeout)
    else:
        reader, writer = await conn
    try:
        hdrs = Headers({"Host": f"{host}:{port}", "Connection": "close"})
        for k, v in (headers or {}).items():
            hdrs[k] = v
        if data is not None:
            hdrs["Content-Length"] = str(len(data))
            if "Content-Type" not in hdrs:
                hdrs["Content-Type"] = "application/json"
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        lines = [f"{method} {target} HTTP/1.1"]
        lines += [f"{k}: {v}" for k, v in hdrs.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                     + (data or b""))
        await writer.drain()
        while True:
            line, rhead = await _read_head(reader)
            parts = line.split(" ", 2)
            if len(parts) < 2 or not parts[0].startswith("HTTP/") \
                    or not parts[1].isdigit():
                raise ConnectionError(
                    f"malformed status line {line[:80]!r}")
            if not 100 <= int(parts[1]) < 200:
                break               # an interim answer (100 Continue)
        return ClientResponse(int(parts[1]), rhead, reader, writer)
    except BaseException:
        writer.close()
        raise
