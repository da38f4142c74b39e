"""Request plane: multiplexed streaming RPC between runtime processes.

Port of `dynamo_tpu/runtime/request_plane.py`, frame for frame on the wire
(runtime/codec.py). A client pushes a request to one instance's endpoint and
receives a response *stream*; the server side hosts many endpoints behind
one listener (ref: ingress/shared_tcp_endpoint.rs, push_endpoint.rs:21).

  * TcpRequestServer / TcpRequestClient — one asyncio TCP listener per
    process, frames multiplexed by request id over pooled connections,
    per-request cancellation propagated as a `cancel` frame, `ping`/`pong`
    liveness probes.
  * MemRequestPlane — in-process direct dispatch for tests.

Handlers are async generators:  async def handler(body, ctx) -> yields bodies.

Every request frame carries the caller's end-to-end deadline as remaining
milliseconds (`x-dynt-deadline-ms`, runtime/resilience.py). The server
refuses a request whose budget is spent before it dispatches it, and arms a
`DeadlineWatchdog` that cancels the handler at expiry (an in-band
`deadline_exceeded` error frame). The client bounds the wait for the first
frame and for every later one by DYNT_STREAM_IDLE_TIMEOUT_SECS, clamped to
the deadline: a black-holed peer (open connection, nothing flowing) raises
ConnectionLost, an exhausted budget DeadlineExceeded.

Not ported yet: the HTTP request plane.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
import threading
import time
from typing import Any, AsyncIterator, Callable, Optional

from ..config import env
from . import codec
from .metrics import DEADLINE_EXCEEDED
from .resilience import (
    Deadline,
    DeadlineExceeded,
    DeadlineWatchdog,
    bounded_wait,
)

log = logging.getLogger("dynamo_tpu_torch.request_plane")

Handler = Callable[[Any, "RequestContext"], AsyncIterator[Any]]


class EndpointNotFound(RuntimeError):
    pass


class RemoteError(RuntimeError):
    """Error raised by the remote handler (application level)."""

    def __init__(self, message: str, code: str = "handler_error") -> None:
        super().__init__(message)
        self.code = code


class ConnectionLost(RuntimeError):
    """Transport-level failure — marks the instance down
    (ref: push_router.rs:8-16 CannotConnect/Disconnected/ConnectionTimeout)."""


class RequestContext:
    """Per-request server-side context: id, headers, cancellation
    (ref: components/src/dynamo/vllm/handlers.py _monitor_abort)."""

    def __init__(self, request_id: int, headers: dict, subject: str) -> None:
        self.request_id = request_id
        self.headers = headers or {}
        self.subject = subject
        # End-to-end budget propagated by the caller; handlers size their
        # own downstream waits from remaining().
        self.deadline: Optional[Deadline] = Deadline.from_wire(self.headers)
        self._stopped = asyncio.Event()

    def stop(self) -> None:
        self._stopped.set()

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def remaining(self, default: Optional[float] = None) -> Optional[float]:
        """Seconds of budget left (floored at 0), or `default` when the
        caller propagated no deadline."""
        if self.deadline is None:
            return default
        return max(0.0, self.deadline.remaining())


class _Registry:
    """Endpoint handler table shared by the TCP and mem planes; locked, since
    endpoints register from any thread while the loop resolves subjects."""

    def __init__(self) -> None:
        self._handlers: dict[str, Handler] = {}
        self._lock = threading.Lock()

    def register(self, subject: str, handler: Handler) -> None:
        with self._lock:
            self._handlers[subject] = handler

    def unregister(self, subject: str) -> None:
        with self._lock:
            self._handlers.pop(subject, None)

    def get(self, subject: str) -> Handler:
        try:
            with self._lock:
                return self._handlers[subject]
        except KeyError:
            raise EndpointNotFound(subject) from None


# ---------------------------------------------------------------------------
# TCP server
# ---------------------------------------------------------------------------


class TcpRequestServer:
    def __init__(self, host: str, port: int,
                 advertise_host: Optional[str] = None) -> None:
        self._host = host
        self._port = port
        self._advertise_host = advertise_host or host
        self._registry = _Registry()
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_tasks: set[asyncio.Task] = set()

    @property
    def registry(self) -> _Registry:
        return self._registry

    @property
    def address(self) -> str:
        assert self._server is not None, "server not started"
        port = self._server.sockets[0].getsockname()[1]
        return f"tcp://{self._advertise_host}:{port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port)

    async def close(self) -> None:
        # Cancel live connection handlers before wait_closed(): since 3.12,
        # wait_closed() blocks until all handlers return.
        if self._server is not None:
            self._server.close()
        for task in list(self._conn_tasks):
            task.cancel()
        await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._conn_tasks.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        assert task is not None
        self._conn_tasks.add(task)
        # Per-connection state: in-flight handler tasks keyed by request id.
        inflight: dict[int, asyncio.Task] = {}
        send_lock = asyncio.Lock()
        try:
            while True:
                frame = await codec.read_frame(reader)
                if frame is None:
                    break
                header, payload = frame
                ftype = header.get("t")
                if ftype == "req":
                    rid = header["i"]
                    subject = header.get("s", "")
                    ctx = RequestContext(rid, header.get("h") or {}, subject)
                    body = codec.unpack_body(payload) if payload else None
                    htask = asyncio.create_task(self._run_handler(
                        rid, subject, body, ctx, writer, send_lock))
                    inflight[rid] = htask
                    htask.add_done_callback(
                        lambda _t, r=rid: inflight.pop(r, None))
                elif ftype == "cancel":
                    htask = inflight.get(header["i"])
                    if htask is not None:
                        htask.cancel()
                elif ftype == "ping":
                    async with send_lock:
                        codec.write_frame(
                            writer, {"t": "pong", "i": header.get("i", 0)})
                        await writer.drain()
        except (ConnectionResetError, BrokenPipeError, ValueError) as exc:
            log.debug("connection error: %s", exc)
        finally:
            for htask in inflight.values():
                htask.cancel()
            self._conn_tasks.discard(task)
            writer.close()

    async def _run_handler(self, rid: int, subject: str, body: Any,
                           ctx: RequestContext, writer: asyncio.StreamWriter,
                           send_lock: asyncio.Lock) -> None:
        try:
            handler = self._registry.get(subject)
        except EndpointNotFound:
            await self._send(writer, send_lock, {
                "t": "err", "i": rid, "e": f"endpoint not found: {subject}",
                "c": "not_found"})
            return
        if ctx.deadline is not None and ctx.deadline.expired():
            # The budget was spent in transit: refuse before dispatch, so
            # an already-late request never occupies a worker slot.
            DEADLINE_EXCEEDED.labels(component="server").inc()
            await self._send(writer, send_lock, {
                "t": "err", "i": rid,
                "e": f"deadline expired before dispatch: {subject}",
                "c": "deadline_exceeded"})
            return
        # A dispatched handler is cancelled the moment its budget runs out.
        watchdog = DeadlineWatchdog().arm(ctx.deadline)
        gen = handler(body, ctx)
        try:
            async for item in gen:
                await self._send(writer, send_lock, {"t": "data", "i": rid},
                                 codec.pack_body(item))
            await self._send(writer, send_lock, {"t": "end", "i": rid})
        except asyncio.CancelledError:
            ctx.stop()
            if watchdog.fired:
                # Our own watchdog, not a client cancel: report the overrun
                # on the wire.
                DEADLINE_EXCEEDED.labels(component="server").inc()
                try:
                    await self._send(writer, send_lock, {
                        "t": "err", "i": rid,
                        "e": f"deadline exceeded in {subject}",
                        "c": "deadline_exceeded"})
                except (ConnectionResetError, BrokenPipeError):
                    pass
                return
            # Client went away or cancelled; nothing to send.
            raise
        except Exception as exc:  # noqa: BLE001 — handler errors cross the wire
            log.warning("handler %s failed: %r", subject, exc)
            try:
                await self._send(writer, send_lock, {
                    "t": "err", "i": rid, "e": repr(exc),
                    "c": "handler_error"})
            except (ConnectionResetError, BrokenPipeError):
                pass
        finally:
            watchdog.disarm()
            # Close the handler generator deterministically: a cancel that
            # lands while this task waits in _send leaves the generator
            # parked at a yield, and its finally blocks (the sequence's
            # release) would otherwise wait for garbage collection.
            try:
                await gen.aclose()
            except (Exception, asyncio.CancelledError):  # noqa: BLE001
                pass

    async def _send(self, writer: asyncio.StreamWriter, lock: asyncio.Lock,
                    header: dict, payload: bytes = b"") -> None:
        async with lock:
            codec.write_frame(writer, header, payload)
            await writer.drain()


# ---------------------------------------------------------------------------
# TCP client — pooled, multiplexed
# ---------------------------------------------------------------------------


class _Connection:
    """One multiplexed TCP connection: a reader task demuxes frames into
    per-request queues (ref: egress/tcp_client.rs pooled connections)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer
        self.streams: dict[int, asyncio.Queue] = {}
        self.send_lock = asyncio.Lock()
        self.closed = False
        self.reader_task = asyncio.create_task(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await codec.read_frame(self.reader)
                if frame is None:
                    break
                header, payload = frame
                queue = self.streams.get(header.get("i"))
                if queue is not None:
                    queue.put_nowait((header, payload))
        except (ConnectionResetError, ValueError):
            pass
        finally:
            self.closed = True
            for queue in self.streams.values():
                queue.put_nowait(({"t": "err", "e": "connection lost",
                                   "c": "connection_lost"}, b""))
            self.writer.close()

    async def send(self, header: dict, payload: bytes = b"") -> None:
        if self.closed:
            raise ConnectionLost("connection closed")
        async with self.send_lock:
            codec.write_frame(self.writer, header, payload)
            await self.writer.drain()

    def close(self) -> None:
        self.closed = True
        self.reader_task.cancel()
        self.writer.close()


class TcpRequestClient:
    def __init__(self, connect_timeout: float = 5.0) -> None:
        self._conns: dict[str, _Connection] = {}
        self._conn_locks: dict[str, asyncio.Lock] = {}
        self._next_id = itertools.count(1)
        self._connect_timeout = connect_timeout

    async def _get_conn(self, address: str) -> _Connection:
        conn = self._conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and not conn.closed:
                return conn
            assert address.startswith("tcp://"), address
            host, port = address[len("tcp://"):].rsplit(":", 1)
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port)),
                    timeout=self._connect_timeout)
            except (OSError, asyncio.TimeoutError) as exc:
                raise ConnectionLost(
                    f"cannot connect {address}: {exc}") from exc
            conn = _Connection(reader, writer)
            self._conns[address] = conn
            return conn

    async def call(self, address: str, subject: str, body: Any,
                   headers: Optional[dict] = None) -> AsyncIterator[Any]:
        """Issue a request; yields response bodies until end-of-stream."""
        conn = await self._get_conn(address)
        rid = next(self._next_id)
        queue: asyncio.Queue = asyncio.Queue()
        conn.streams[rid] = queue
        ended = False
        deadline = Deadline.from_wire(headers)
        # A black-holed peer keeps the connection open while nothing flows:
        # the idle timeout bounds the first frame and every later one, and
        # each wait is clamped to the deadline.
        idle = env("DYNT_STREAM_IDLE_TIMEOUT_SECS") or None
        try:
            await conn.send({"t": "req", "i": rid, "s": subject,
                             "h": headers or {}}, codec.pack_body(body))
            while True:
                try:
                    header, payload = await bounded_wait(
                        queue.get(), idle, deadline, subject)
                except asyncio.TimeoutError:
                    raise ConnectionLost(
                        f"no frame from {address} in {idle}s "
                        f"({subject})") from None
                ftype = header.get("t")
                if ftype == "data":
                    yield codec.unpack_body(payload)
                elif ftype == "end":
                    ended = True
                    return
                elif ftype == "err":
                    ended = True
                    code = header.get("c", "handler_error")
                    if code == "connection_lost":
                        raise ConnectionLost(
                            header.get("e", "connection lost"))
                    if code == "not_found":
                        raise EndpointNotFound(header.get("e", subject))
                    if code == "deadline_exceeded":
                        raise DeadlineExceeded(header.get("e", subject))
                    raise RemoteError(header.get("e", "remote error"), code)
        finally:
            conn.streams.pop(rid, None)
            # Propagate cancellation to the server only if the stream did
            # not finish cleanly. Bounded: a black-holed peer has a full
            # socket buffer, and an unbounded drain() would hold every
            # sender queued on this connection's lock.
            if not ended and not conn.closed:
                try:
                    await asyncio.wait_for(
                        conn.send({"t": "cancel", "i": rid}), 2.0)
                except (ConnectionLost, ConnectionResetError,
                        asyncio.TimeoutError):
                    pass

    async def ping(self, address: str, timeout: float = 5.0) -> float:
        """Liveness probe: round-trips a ping frame through the peer's frame
        loop (no handler dispatch), returning the RTT in seconds."""
        conn = await self._get_conn(address)
        rid = next(self._next_id)
        queue: asyncio.Queue = asyncio.Queue()
        conn.streams[rid] = queue
        start = time.monotonic()

        async def probe() -> dict:
            # The send is inside the timeout: a peer with a full socket
            # buffer blocks drain() under the send lock.
            await conn.send({"t": "ping", "i": rid})
            header, _ = await queue.get()
            return header

        try:
            header = await asyncio.wait_for(probe(), timeout)
            if header.get("t") != "pong":
                raise ConnectionLost(
                    f"expected pong, got {header.get('t')!r} "
                    f"({header.get('e', '')})")
            return time.monotonic() - start
        except asyncio.TimeoutError:
            raise ConnectionLost(
                f"ping timeout after {timeout}s: {address}") from None
        finally:
            conn.streams.pop(rid, None)

    async def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()


# ---------------------------------------------------------------------------
# In-process plane for tests
# ---------------------------------------------------------------------------


class MemRequestPlane:
    """Direct-dispatch request plane: addresses are mem://<token> and map to
    registries in this process."""

    _registries: dict[str, _Registry] = {}
    _counter = itertools.count(1)

    @classmethod
    def create_server(cls) -> "MemRequestServer":
        address = f"mem://{next(cls._counter)}"
        registry = _Registry()
        cls._registries[address] = registry
        return MemRequestServer(address, registry)

    @classmethod
    async def call(cls, address: str, subject: str, body: Any,
                   headers: Optional[dict] = None) -> AsyncIterator[Any]:
        registry = cls._registries.get(address)
        if registry is None:
            raise ConnectionLost(f"no mem server at {address}")
        handler = registry.get(subject)
        ctx = RequestContext(0, headers or {}, subject)
        if ctx.deadline is not None and ctx.deadline.expired():
            # The TCP server's refuse-before-dispatch contract.
            DEADLINE_EXCEEDED.labels(component="server").inc()
            raise DeadlineExceeded(
                f"deadline expired before dispatch: {subject}")
        try:
            async with contextlib.aclosing(handler(body, ctx)) as gen:
                async for item in gen:
                    # round-trip through msgpack, as over TCP
                    yield codec.unpack_body(codec.pack_body(item))
        finally:
            ctx.stop()


class MemRequestServer:
    def __init__(self, address: str, registry: _Registry) -> None:
        self.address = address
        self.registry = registry

    async def start(self) -> None:
        pass

    async def close(self) -> None:
        MemRequestPlane._registries.pop(self.address, None)


class RequestClient:
    """Facade that routes by address scheme (tcp:// or mem://): a worker's
    advertised address selects its transport."""

    def __init__(self, connect_timeout: float = 5.0) -> None:
        self._tcp = TcpRequestClient(connect_timeout=connect_timeout)

    def call(self, address: str, subject: str, body: Any,
             headers: Optional[dict] = None) -> AsyncIterator[Any]:
        if address.startswith("mem://"):
            return MemRequestPlane.call(address, subject, body, headers)
        if address.startswith("http://"):
            raise ConnectionLost(
                f"the HTTP request plane is not ported yet: {address}")
        return self._tcp.call(address, subject, body, headers)

    async def close(self) -> None:
        await self._tcp.close()
