"""A minimal asyncio HTTP/1.1 server for the frontend and the status server.

Stands in for `aiohttp.web`: the package depends on torch, numpy and the
standard library only. It serves what the OpenAI routes and /health, /live and /metrics need, and no
more: a request line, headers and a `Content-Length` body, keep-alive, JSON
and text responses, and streamed responses written with chunked transfer
encoding (SSE). While a handler runs, the connection is watched: a client
that closes its socket cancels the handler task, so the cancellation reaches
whatever the handler awaits (the request plane turns it into a `cancel`
frame). Header and body sizes are bounded; an unrouted path answers 404 and
a routed path with another method 405, with aiohttp's bodies.
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
from typing import Any, Awaitable, Callable, Optional, Union
from urllib.parse import parse_qsl, urlsplit

log = logging.getLogger("dynamo_tpu_torch.http")

MAX_HEADER_BYTES = 64 * 1024
MAX_HEADERS = 100
MAX_BODY_BYTES = 1024 ** 2  # aiohttp's default client_max_size


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: dict[str, str], conn: "_Conn") -> None:
        self.method = method
        url = urlsplit(target)
        self.path = url.path
        # the query's parameters; a repeated name keeps its first value, as
        # aiohttp's `request.query.get` reads it
        self.query: dict[str, str] = {}
        for name, value in parse_qsl(url.query, keep_blank_values=True):
            self.query.setdefault(name, value)
        self.version = version
        self.headers = headers  # lower-case names
        self.body = b""
        self._conn = conn
        self.streaming = False  # a StreamResponse has sent its head

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    def json(self) -> Any:
        return json.loads(self.body)


class Response:
    def __init__(self, body: Union[bytes, str] = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[dict] = None) -> None:
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}

    def encode(self, keep_alive: bool) -> bytes:
        headers = dict(self.headers, **{"Content-Length": str(len(self.body))})
        if not keep_alive:
            headers["Connection"] = "close"
        return _head(self.status, headers) + self.body


class HTTPError(Exception):
    """Raise from a handler to answer with this response."""

    def __init__(self, response: Response) -> None:
        super().__init__(response.status)
        self.response = response


def json_response(data: Any, status: int = 200,
                  headers: Optional[dict] = None) -> Response:
    return Response(json.dumps(data), status, "application/json", headers)


def _head(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _plain(status: int, headers: Optional[dict] = None) -> Response:
    return Response(f"{status}: {http.HTTPStatus(status).phrase}", status,
                    headers=headers)


class StreamResponse:
    """A response written in chunks as the handler produces them."""

    def __init__(self, status: int = 200,
                 headers: Optional[dict] = None) -> None:
        self.status = status
        self.headers = dict(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None
        self.finished = False

    async def prepare(self, request: Request) -> None:
        request.streaming = True
        self._writer = request._conn.writer
        self._writer.write(_head(self.status, dict(
            self.headers, **{"Transfer-Encoding": "chunked"})))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        assert self._writer is not None, "prepare() first"
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self) -> None:
        if self._writer is not None and not self.finished:
            self.finished = True
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class _BadRequest(Exception):
    def __init__(self, status: int) -> None:
        super().__init__(status)
        self.status = status


class _Conn:
    """Buffered reads over one connection; data that arrives while a handler
    runs (a pipelined request) is kept for the next parse."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer
        self.buf = bytearray()
        self.eof = False

    async def _fill(self) -> bool:
        data = await self.reader.read(65536)
        if not data:
            self.eof = True
            return False
        self.buf += data
        return True

    async def read_request(self) -> Optional[Request]:
        while b"\r\n\r\n" not in self.buf:
            if len(self.buf) > MAX_HEADER_BYTES:
                raise _BadRequest(431)
            if self.eof or not await self._fill():
                if self.buf.strip():
                    raise _BadRequest(400)
                return None
        end = self.buf.index(b"\r\n\r\n")
        if end > MAX_HEADER_BYTES:
            raise _BadRequest(431)
        head = bytes(self.buf[:end]).decode("latin-1")
        del self.buf[:end + 4]
        lines = head.split("\r\n")
        try:
            method, target, version = lines[0].split(" ")
        except ValueError:
            raise _BadRequest(400) from None
        if not version.startswith("HTTP/1."):
            raise _BadRequest(505)
        if len(lines) - 1 > MAX_HEADERS:
            raise _BadRequest(431)
        headers: dict[str, str] = {}
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep or not name.strip():
                raise _BadRequest(400)
            headers[name.strip().lower()] = value.strip()
        request = Request(method.upper(), target, version, headers, self)
        if "transfer-encoding" in headers:
            raise _BadRequest(411)  # only Content-Length bodies
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400) from None
        if length < 0:
            raise _BadRequest(400)
        if length > MAX_BODY_BYTES:
            raise _BadRequest(413)
        if length and headers.get("expect", "").lower() == "100-continue":
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await self.writer.drain()
        while len(self.buf) < length:
            if self.eof or not await self._fill():
                return None
        request.body = bytes(self.buf[:length])
        del self.buf[:length]
        return request

    async def watch_eof(self) -> bool:
        """Wait for the client to close (True) or send more data (False)."""
        return not await self._fill()


class HttpServer:
    def __init__(self, routes: dict[tuple[str, str], Handler],
                 host: str = "0.0.0.0", port: int = 0) -> None:
        self.routes = {(m.upper(), p): h for (m, p), h in routes.items()}
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_tasks: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_conn,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._conn_tasks):
            task.cancel()
        await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._conn_tasks.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    def _route(self, request: Request) -> Handler:
        handler = self.routes.get((request.method, request.path))
        if handler is not None:
            return handler
        allowed = sorted(m for m, p in self.routes if p == request.path)
        if allowed:
            raise HTTPError(_plain(405, {"Allow": ",".join(allowed)}))
        raise HTTPError(_plain(404))

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        assert task is not None
        self._conn_tasks.add(task)
        conn = _Conn(reader, writer)
        try:
            while True:
                try:
                    request = await conn.read_request()
                except _BadRequest as exc:
                    writer.write(_plain(exc.status).encode(keep_alive=False))
                    await writer.drain()
                    break
                if request is None:
                    break
                response = await self._dispatch(request, conn)
                if response is None:  # the client went away
                    break
                keep = request.keep_alive
                if isinstance(response, StreamResponse):
                    await response.write_eof()
                else:
                    writer.write(response.encode(keep))
                    await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError) as exc:
            log.debug("http connection error: %r", exc)
        finally:
            self._conn_tasks.discard(task)
            writer.close()

    async def _dispatch(self, request: Request, conn: _Conn,
                        ) -> Optional[Union[Response, StreamResponse]]:
        try:
            handler = self._route(request)
        except HTTPError as exc:
            return exc.response
        work = asyncio.ensure_future(self._call(handler, request))
        watch = (None if conn.eof
                 else asyncio.ensure_future(conn.watch_eof()))
        try:
            if watch is not None:
                await asyncio.wait({work, watch},
                                   return_when=asyncio.FIRST_COMPLETED)
                if watch.done() and (watch.exception() is not None
                                     or watch.result()):
                    # The client closed its socket: cancel the handler.
                    work.cancel()
                    await asyncio.gather(work, return_exceptions=True)
                    return None
            return await work
        finally:
            if watch is not None and not watch.done():
                watch.cancel()
                await asyncio.gather(watch, return_exceptions=True)
            if not work.done():
                work.cancel()
                await asyncio.gather(work, return_exceptions=True)

    async def _call(self, handler: Handler, request: Request,
                    ) -> Optional[Union[Response, StreamResponse]]:
        try:
            return await handler(request)
        except HTTPError as exc:
            return exc.response
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception:  # noqa: BLE001 — a handler failure answers 500
            log.exception("handler for %s %s failed", request.method,
                          request.path)
            # After a streamed head the only answer left is to drop the
            # connection, as aiohttp does.
            return None if request.streaming else _plain(500)
