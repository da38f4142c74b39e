"""ZMTP 3.0 PUB/SUB on asyncio streams, the NULL mechanism only.

The JAX package's default event plane is a ZeroMQ PUB socket per worker and
one SUB socket per router, through pyzmq. This package depends on torch,
numpy and the standard library only, so it speaks the wire protocol itself
(ZMTP 3.0, rfc.zeromq.org/spec/23; the subscription forms of ZMTP 3.1,
spec/37). A libzmq SUB reads this publisher and this subscriber reads a
libzmq PUB:

  * greeting: 64 bytes — signature ff 00*8 7f, version 3.0, mechanism
    "NULL" padded to 20 bytes, as-server 0, 31 bytes of filler;
  * handshake: each side sends a READY command whose `Socket-Type`
    property is PUB or SUB;
  * frames: a flags byte (0x01 more, 0x02 long, 0x04 command), then a
    1-byte or an 8-byte big-endian size, then the body;
  * subscriptions: a SUB sends a one-frame message `\\x01` + prefix
    (`\\x00` + prefix cancels); a ZMTP 3.1 peer may send the SUBSCRIBE /
    CANCEL commands instead, which are accepted too. Advertising 3.0 keeps
    libzmq to the message form.

The publisher filters by prefix on its side against the first frame, as
libzmq does, and keeps one queue per peer: past `hwm` queued messages
(libzmq's default high-water mark, 1000) a peer's new messages are
dropped, so a slow subscriber never blocks the publisher. A subscriber
reconnects after a lost connection, as libzmq does every 100 ms.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import logging
import socket
from typing import Callable, Optional

log = logging.getLogger("dynamo_tpu_torch.zmtp")

GREETING = (b"\xff" + b"\x00" * 8 + b"\x7f" + b"\x03\x00"
            + b"NULL".ljust(20, b"\x00") + b"\x00" + b"\x00" * 31)
MORE, LONG, COMMAND = 0x01, 0x02, 0x04
DEFAULT_HWM = 1000
HANDSHAKE_TIMEOUT = 30.0  # libzmq's ZMQ_HANDSHAKE_IVL
RECONNECT_SECS = 0.1  # libzmq's ZMQ_RECONNECT_IVL
MAX_FRAME = 256 << 20  # a larger declared size is a broken peer


class ProtocolError(ConnectionError):
    pass


def encode_frame(body: bytes, more: bool = False,
                 command: bool = False) -> bytes:
    flags = (MORE if more else 0) | (COMMAND if command else 0)
    if len(body) <= 0xFF:
        return bytes((flags, len(body))) + body
    return bytes((flags | LONG,)) + len(body).to_bytes(8, "big") + body


def encode_message(frames: list[bytes]) -> bytes:
    last = len(frames) - 1
    return b"".join(encode_frame(f, more=i < last)
                    for i, f in enumerate(frames))


def encode_command(name: str, data: bytes = b"") -> bytes:
    raw = name.encode("ascii")
    return encode_frame(bytes((len(raw),)) + raw + data, command=True)


def encode_ready(socket_type: str) -> bytes:
    name, value = b"Socket-Type", socket_type.encode("ascii")
    return encode_command("READY", bytes((len(name),)) + name
                          + len(value).to_bytes(4, "big") + value)


def parse_command(body: bytes) -> tuple[str, bytes]:
    if not body or len(body) < 1 + body[0]:
        raise ProtocolError("malformed command frame")
    n = body[0]
    return body[1:1 + n].decode("ascii", "replace"), body[1 + n:]


def parse_properties(data: bytes) -> dict[str, bytes]:
    props, pos = {}, 0
    while pos < len(data):
        n = data[pos]
        name = data[pos + 1:pos + 1 + n].decode("ascii", "replace")
        pos += 1 + n
        if pos + 4 > len(data):
            raise ProtocolError("malformed READY properties")
        size = int.from_bytes(data[pos:pos + 4], "big")
        props[name.lower()] = data[pos + 4:pos + 4 + size]
        pos += 4 + size
    return props


async def read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes]:
    """(flags, body) of the next frame."""
    head = await reader.readexactly(2)
    flags = head[0]
    if flags & LONG:
        size = int.from_bytes(head[1:] + await reader.readexactly(7), "big")
    else:
        size = head[1]
    if size > MAX_FRAME:
        raise ProtocolError(f"frame of {size} bytes")
    return flags, await reader.readexactly(size)


async def handshake(reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter, socket_type: str,
                    peer_types: tuple[str, ...]) -> None:
    """Exchange greetings and READY commands; raises ProtocolError unless
    the peer speaks ZMTP 3 with the NULL mechanism as one of `peer_types`."""
    writer.write(GREETING + encode_ready(socket_type))
    await writer.drain()
    greeting = await reader.readexactly(64)
    if greeting[0] != 0xFF or not greeting[9] & 0x01:
        raise ProtocolError("not a ZMTP peer")
    if greeting[10] < 3:
        raise ProtocolError(f"ZMTP {greeting[10]}.{greeting[11]} peer")
    if greeting[12:32].rstrip(b"\x00") != b"NULL":
        raise ProtocolError(
            f"mechanism {greeting[12:32].rstrip(bytes(1))!r}, not NULL")
    flags, body = await read_frame(reader)
    if not flags & COMMAND:
        raise ProtocolError("expected the READY command")
    name, data = parse_command(body)
    if name != "READY":
        raise ProtocolError(f"expected READY, got {name}")
    peer = parse_properties(data).get("socket-type", b"").decode(
        "ascii", "replace")
    if peer not in peer_types:
        raise ProtocolError(f"{socket_type} cannot talk to a {peer!r} socket")


def _close(writer: asyncio.StreamWriter) -> None:
    with contextlib.suppress(Exception):
        writer.close()


class _Peer:
    """One subscriber connection of a ZmtpPublisher."""

    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self.writer = writer
        self.subscriptions: collections.Counter = collections.Counter()
        self.queue: collections.deque = collections.deque()
        self.wake = asyncio.Event()
        self.dropped = 0

    def wants(self, topic: bytes) -> bool:
        return any(topic.startswith(p) for p in self.subscriptions)


class ZmtpPublisher:
    """A PUB socket bound on `host` (port 0: ephemeral). The listening
    socket is bound at construction, so `address` is known at once; serving
    starts at `start()`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 hwm: int = DEFAULT_HWM) -> None:
        self._sock = socket.create_server((host, port))
        self.address = f"tcp://{host}:{self._sock.getsockname()[1]}"
        self.hwm = hwm
        self.peers: set[_Peer] = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: set[asyncio.Task] = set()

    async def start(self) -> None:
        if self._server is None:
            self._server = await asyncio.start_server(self._accept,
                                                      sock=self._sock)

    def subscribed(self) -> int:
        """Peers holding at least one subscription."""
        return sum(1 for p in self.peers if p.subscriptions)

    def dropped(self) -> int:
        return sum(p.dropped for p in self.peers)

    def send(self, frames: list[bytes]) -> None:
        """Queue one message for every peer subscribed to a prefix of its
        first frame; never blocks."""
        data = None
        for peer in self.peers:
            if not peer.wants(frames[0]):
                continue
            if len(peer.queue) >= self.hwm:
                peer.dropped += 1
                continue
            if data is None:
                data = encode_message(frames)
            peer.queue.append(data)
            peer.wake.set()

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._tasks.add(asyncio.current_task())
        peer = _Peer(writer)
        try:
            await asyncio.wait_for(
                handshake(reader, writer, "PUB", ("SUB", "XSUB")),
                HANDSHAKE_TIMEOUT)
            self.peers.add(peer)
            sender = asyncio.create_task(self._send_loop(peer))
            try:
                await self._read_loop(reader, peer)
            finally:
                sender.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await sender
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, OSError) as exc:
            log.debug("subscriber connection ended: %r", exc)
        finally:
            self.peers.discard(peer)
            _close(writer)
            self._tasks.discard(asyncio.current_task())

    async def _read_loop(self, reader, peer: _Peer) -> None:
        while True:
            flags, body = await read_frame(reader)
            if flags & COMMAND:
                name, data = parse_command(body)
                if name == "SUBSCRIBE":
                    peer.subscriptions[data] += 1
                elif name == "CANCEL":
                    self._cancel(peer, data)
                continue  # heartbeats are not set up: nothing else comes
            if flags & MORE:  # a SUB sends nothing multi-frame: skip it
                while flags & MORE:
                    flags, _ = await read_frame(reader)
                continue
            if body[:1] == b"\x01":
                peer.subscriptions[body[1:]] += 1
            elif body[:1] == b"\x00":
                self._cancel(peer, body[1:])

    @staticmethod
    def _cancel(peer: _Peer, prefix: bytes) -> None:
        if peer.subscriptions[prefix] > 1:
            peer.subscriptions[prefix] -= 1
        else:
            peer.subscriptions.pop(prefix, None)

    async def _send_loop(self, peer: _Peer) -> None:
        while True:
            await peer.wake.wait()
            peer.wake.clear()
            while peer.queue:
                peer.writer.write(peer.queue.popleft())
                await peer.writer.drain()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        else:
            self._sock.close()
        for peer in list(self.peers):
            _close(peer.writer)
        for task in list(self._tasks):
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self._server is not None:
            with contextlib.suppress(Exception):
                await self._server.wait_closed()


class ZmtpSubscriber:
    """A SUB connection to one publisher at `address` (tcp://host:port),
    subscribed to `prefixes`; every message that matches one goes to
    `on_message(frames)`. Reconnects until closed."""

    def __init__(self, address: str, prefixes: list[bytes],
                 on_message: Callable[[list[bytes]], None]) -> None:
        host, _, port = address.removeprefix("tcp://").rpartition(":")
        self.address = address
        self._host, self._port = host.strip("[]"), int(port)
        self._prefixes = list(prefixes)
        self._on_message = on_message
        self.connected = asyncio.Event()
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            writer = None
            try:
                reader, writer = await asyncio.open_connection(self._host,
                                                               self._port)
                await asyncio.wait_for(
                    handshake(reader, writer, "SUB", ("PUB", "XPUB")),
                    HANDSHAKE_TIMEOUT)
                writer.write(b"".join(encode_frame(b"\x01" + p)
                                      for p in self._prefixes))
                await writer.drain()
                self.connected.set()
                await self._read_loop(reader)
            except (ConnectionError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, OSError) as exc:
                log.debug("publisher %s: %r", self.address, exc)
            finally:
                self.connected.clear()
                if writer is not None:
                    _close(writer)
            await asyncio.sleep(RECONNECT_SECS)

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        frames: list[bytes] = []
        while True:
            flags, body = await read_frame(reader)
            if flags & COMMAND:
                continue  # nothing but READY is expected
            frames.append(body)
            if flags & MORE:
                continue
            message, frames = frames, []
            if any(message[0].startswith(p) for p in self._prefixes):
                self._on_message(message)

    async def close(self) -> None:
        self._task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await self._task
