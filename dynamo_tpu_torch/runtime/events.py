"""Event plane: topic pub/sub for KV events and load metrics.

Port of `dynamo_tpu/runtime/events.py` on the standard library, with its
three transports and their wire formats:

  * mem — a process-local topic bus (prefix matching like a SUB socket);
    payloads take a msgpack round trip, as on the wire;
  * zmq — the reference's default (DYNT_EVENT_PLANE=zmq): each publisher
    binds a PUB socket and advertises its address in discovery under the
    runtime's lease (`v1/events/{namespace}/{publisher_id}` ->
    {"address": "tcp://host:port"}); a subscriber manager watches that
    prefix and connects to every publisher it finds. Messages are two
    frames, the topic (utf-8) and a msgpack payload. The reference speaks
    it through pyzmq; here `runtime/zmtp.py` speaks ZMTP 3.0 itself, so
    libzmq peers and these interoperate both ways;
  * journal — a durable, replayable log per publisher on shared storage,
    byte for byte the reference's: the `DYNJRNL1` preamble, `>II` (length,
    crc32) frames of msgpack {"t": topic, "p": payload}, generations
    rotated with a snapshot seeded by `set_snapshot_fn`, torn tails left
    for the next poll and corrupt frames skipped with a
    JOURNAL_RESYNC_TOPIC event.

msgpack is this package's (`runtime/msgpack.py`), byte-equal to the
wheel's.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import threading
import time
import uuid
import zlib
from typing import Any, AsyncIterator, Callable, Optional

from .discovery import Discovery, Lease
from .msgpack import packb, unpackb
from .zmtp import ZmtpPublisher, ZmtpSubscriber

log = logging.getLogger("dynamo_tpu_torch.events")

EVENT_PREFIX = "v1/events"


class EventPublisher:
    async def publish(self, topic: str, payload: Any) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class EventSubscriber:
    """Async iterator of (topic, payload)."""

    def __init__(self) -> None:
        self._queue: asyncio.Queue = asyncio.Queue()
        self._closed = False

    def _emit(self, topic: str, payload: Any) -> None:
        if not self._closed:
            self._queue.put_nowait((topic, payload))

    async def close(self) -> None:
        self._closed = True
        self._queue.put_nowait(None)

    def __aiter__(self) -> AsyncIterator:
        return self

    async def __anext__(self):
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        return item


# ---------------------------------------------------------------------------
# In-process bus
# ---------------------------------------------------------------------------


class _MemBus:
    def __init__(self) -> None:
        self.subscribers: list[tuple[str, EventSubscriber,
                                     asyncio.AbstractEventLoop]] = []


_MEM_BUSES: dict[str, _MemBus] = {}


class MemEventPlane:
    """Process-local topic bus (topic prefix matching like ZMQ SUB)."""

    def __init__(self, cluster: str = "default") -> None:
        self._bus = _MEM_BUSES.setdefault(cluster, _MemBus())

    def publisher(self) -> "MemEventPublisher":
        return MemEventPublisher(self._bus)

    def subscribe(self, topic_prefix: str) -> EventSubscriber:
        sub = EventSubscriber()
        self._bus.subscribers.append(
            (topic_prefix, sub, asyncio.get_running_loop()))
        return sub


class MemEventPublisher(EventPublisher):
    def __init__(self, bus: _MemBus) -> None:
        self._bus = bus

    async def publish(self, topic: str, payload: Any) -> None:
        # msgpack round-trip keeps parity with the wire transports
        data = unpackb(packb(payload))
        for entry in list(self._bus.subscribers):
            prefix, sub, loop = entry
            if loop.is_closed() or sub._closed:
                # Subscriber's loop died (e.g. a previous test's): prune.
                try:
                    self._bus.subscribers.remove(entry)
                except ValueError:
                    pass
                continue
            if topic.startswith(prefix):
                loop.call_soon_threadsafe(sub._emit, topic, data)


# ---------------------------------------------------------------------------
# ZMQ transport (ref: transports/event_plane/zmq_transport.rs), over ZMTP
# ---------------------------------------------------------------------------


class ZmqEventPublisher(EventPublisher):
    """Binds a PUB socket on an ephemeral port and advertises it in
    discovery under the runtime's lease, so subscribers find it and crashes
    clean up. `publish` never blocks: a subscriber past the high-water mark
    loses messages (the router's gap detection resyncs it)."""

    def __init__(self, namespace: str, discovery: Discovery,
                 lease: Optional[Lease], host: str = "127.0.0.1",
                 put_leased=None, delete_leased=None) -> None:
        self._pub = ZmtpPublisher(host)
        self.address = self._pub.address
        self.publisher_id = uuid.uuid4().hex
        self._namespace = namespace
        self._discovery = discovery
        self._lease = lease
        # Runtime-tracked put/delete: the advertisement survives a
        # discovery outage (lease re-grant replays it) AND close() drops
        # it from the replay set. The raw path remains for lease-less
        # construction.
        self._put_leased = put_leased
        self._delete_leased = delete_leased
        self._advertised = False

    @property
    def key(self) -> str:
        return f"{EVENT_PREFIX}/{self._namespace}/{self.publisher_id}"

    async def advertise(self) -> None:
        await self._pub.start()
        value = {"address": self.address}
        if self._put_leased is not None:
            await self._put_leased(self.key, value)
        else:
            await self._discovery.put(self.key, value, self._lease)
        self._advertised = True
        # PUB/SUB joins are async; give late subscribers a chance on first
        # use.
        await asyncio.sleep(0)

    async def publish(self, topic: str, payload: Any) -> None:
        if not self._advertised:
            await self.advertise()
        self._pub.send([topic.encode(), packb(payload)])

    async def close(self) -> None:
        try:
            if self._delete_leased is not None:
                await self._delete_leased(self.key)
            else:
                await self._discovery.delete(self.key)
        except Exception:  # noqa: BLE001 — discovery may already be closed
            pass
        await self._pub.close()


class ZmqEventSubscriberManager:
    """Watches discovery for publishers in a namespace and keeps a SUB
    connection to each of them (ref: kv_router/subscriber.rs watching the
    event plane). A publisher whose advertisement is deleted is
    disconnected."""

    def __init__(self, namespace: str, discovery: Discovery,
                 topic_prefix: str) -> None:
        self._namespace = namespace
        self._discovery = discovery
        self._prefix = topic_prefix.encode()
        self._connections: dict[str, ZmtpSubscriber] = {}  # key -> conn
        self._tasks: list[asyncio.Task] = []
        self._watch = None
        self._subscriber = EventSubscriber()

    async def start(self) -> EventSubscriber:
        self._watch = await self._discovery.watch_prefix(
            f"{EVENT_PREFIX}/{self._namespace}/")
        self._tasks.append(asyncio.create_task(self._watch_loop()))
        return self._subscriber

    def _on_message(self, frames: list[bytes]) -> None:
        if len(frames) != 2:
            log.warning("dropping an event message of %d frames",
                        len(frames))
            return
        try:
            payload = unpackb(frames[1])
        except Exception:  # noqa: BLE001 — one bad message, not the loop
            log.exception("undecodable event payload")
            return
        self._subscriber._emit(frames[0].decode(), payload)

    async def _watch_loop(self) -> None:
        async for event in self._watch:
            if event.kind == "put" and event.value:
                address = event.value.get("address")
                conn = self._connections.get(event.key)
                if conn is not None and conn.address == address:
                    continue
                if conn is not None:
                    await conn.close()
                if address:
                    self._connections[event.key] = ZmtpSubscriber(
                        address, [self._prefix], self._on_message)
            elif event.kind == "delete":
                conn = self._connections.pop(event.key, None)
                if conn is not None:
                    await conn.close()

    async def close(self) -> None:
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self._watch is not None:
            await self._watch.cancel()
        for conn in self._connections.values():
            await conn.close()
        self._connections.clear()
        await self._subscriber.close()


# ---------------------------------------------------------------------------
# Journal transport: durable, replayable event log on shared storage
# (ref: lib/llm/src/kv_router/jetstream.rs + router-design.md "JetStream
# Mode" — a durable stream so ROUTER REPLICAS recover state after restart
# without querying workers; a directory of per-publisher append-only logs
# on storage all replicas mount, the substrate FileDiscovery uses.)
# ---------------------------------------------------------------------------

# Frame header: big-endian (length, crc32-of-body). Lengths above this
# bound are corruption, not a frame still being appended — no legitimate
# journal frame approaches it (the codec chunks payloads well below).
_JOURNAL_MAX_FRAME = 64 << 20
# File preamble marking the CRC-framed format. The reference also replays
# pre-CRC journals (no preamble, [len][body] frames) written before that
# format; this package reads the CRC format only, so such a file's frames
# count as corrupt.
_JOURNAL_MAGIC = b"DYNJRNL1"
# Synthetic subscriber event emitted when corrupt frames were skipped:
# consumers holding derived state (radix routers, standalone indexers)
# schedule a worker resync (dump_worker/load_worker round-trip) instead
# of silently diverging on the lost events. Always delivered, bypassing
# the subscriber's topic-prefix filter.
JOURNAL_RESYNC_TOPIC = "_journal/resync"


def _journal_pack(topic: str, payload: Any) -> bytes:
    body = packb({"t": topic, "p": payload})
    return struct.pack(">II", len(body), zlib.crc32(body)) + body


_PARTIAL = "partial"


def _try_frame(buf: bytes, pos: int):
    """Parse one frame at pos: (next_pos, topic, payload) on success,
    _PARTIAL when the buffer ends inside a plausible frame (torn tail —
    wait for the next poll), None when the bytes are corrupt (bad
    length, CRC mismatch, or undecodable body)."""
    n = len(buf)
    if pos + 8 > n:
        return _PARTIAL
    length, crc = struct.unpack_from(">II", buf, pos)
    if length > _JOURNAL_MAX_FRAME:
        return None
    if pos + 8 + length > n:
        return _PARTIAL
    body = buf[pos + 8 : pos + 8 + length]
    if zlib.crc32(body) != crc:
        return None
    try:
        frame = unpackb(body)
        return pos + 8 + length, frame["t"], frame["p"]
    except Exception:  # noqa: BLE001 — CRC-passing but undecodable
        # bytes are still corruption (e.g. a zero-filled sparse hole:
        # length 0 / crc 0 checks out, the empty body does not unpack)
        return None


def _scan_next_valid(buf: bytes, start: int) -> Optional[int]:
    """First position >= start where a COMPLETE frame parses (CRC +
    msgpack). A 32-bit CRC over the candidate's full body makes a false
    re-sync point vanishingly unlikely."""
    n = len(buf)
    for pos in range(start, max(start, n - 8) + 1):
        if _try_frame(buf, pos) not in (None, _PARTIAL):
            return pos
    return None


def _scan_next_partial(buf: bytes, start: int) -> Optional[int]:
    """First position >= start that could be the START of a frame whose
    remainder has not been written yet (plausible header, body past
    EOF). Used when corruption leaves no COMPLETE frame: the consumed
    garbage must stop IN FRONT of such a candidate — eating a
    half-written valid frame's prefix would make its remaining bytes
    parse as garbage on the next poll and cascade the loss."""
    for pos in range(start, len(buf)):
        if _try_frame(buf, pos) is _PARTIAL:
            return pos
    return None


def _journal_read(buf: bytes, offset: int, on_bad=None,
                  scan_partial: bool = True):
    """Yield (next_offset, topic, payload) for complete frames in buf
    from offset. A trailing partial frame (torn write from a crashed
    publisher) is left for the next poll. A CORRUPT frame (CRC mismatch,
    implausible length, zero-fill from a truncate-then-append hole) does
    not wedge replay: the reader re-syncs to the next CRC-valid frame —
    or, when nothing valid remains, consumes to EOF so fresh appends
    land on a clean boundary (the generation-boundary fallback). Each
    skip calls `on_bad(1)` so subscribers can count it and signal a
    worker resync for the derived state the lost frames fed.

    `scan_partial=False` skips the byte-by-byte resync scan for a
    PLAUSIBLE partial tail (a corrupted length field is indistinguishable
    from a frame still being appended): callers pass False while the file
    is still growing — re-scanning a multi-MB half-written snapshot frame
    on every poll is O(tail²) for nothing — and True once it stagnates,
    which is when "still appending" stops being the likely explanation.
    Mid-buffer corruption (CRC/length/decode failures) always scans."""
    n = len(buf)
    while True:
        parsed = _try_frame(buf, offset)
        if parsed is _PARTIAL:
            # Usually a torn tail that completes on a later poll. But a
            # corrupted length field masquerades as an ever-growing
            # partial frame: if a valid frame exists FURTHER ALONG, the
            # "partial" here is garbage — skip to it.
            if not scan_partial:
                return
            nxt = _scan_next_valid(buf, offset + 1)
            if nxt is None:
                return
            if on_bad is not None:
                on_bad(1)
            offset = nxt
            continue
        if parsed is None:
            if on_bad is not None:
                on_bad(1)
            nxt = _scan_next_valid(buf, offset + 1)
            if nxt is None:
                # Nothing COMPLETE left — but the tail may hold a valid
                # frame still being APPENDED behind the corruption.
                # Consume only up to the first plausible frame-start
                # (eating a half-written frame's prefix would corrupt
                # it in turn and cascade); with no candidate at all,
                # consume to EOF so the next poll starts at a clean
                # append boundary instead of re-counting these bytes.
                part = _scan_next_partial(buf, offset + 1)
                yield (n if part is None else part), None, None
                return
            offset = nxt
            continue
        offset, topic, payload = parsed
        yield offset, topic, payload


class JournalEventPublisher(EventPublisher):
    """Appends length-prefixed msgpack frames to
    `<root>/<namespace>/<publisher_id>.g<generation>.log`.

    Durability model: a frame is on disk before publish() returns (write +
    flush; fsync is left to the filesystem — same stance as JetStream's
    default file storage). Rotation: past `max_bytes` the publisher starts
    a new generation seeded with snapshot frames from `snapshot_fn` (the
    worker's local-index dump — the state that replaces the discarded
    history). Rotated-away generations are kept on disk for
    `grace_seconds` so subscribers (which poll every ~50ms) can drain
    their tail frames in order before switching to the newest
    generation; only generations retired longer ago than the grace
    period are unlinked. Within that grace window replay is exact; a
    subscriber that lags a rotation by more than grace_seconds falls
    back to the newest generation's snapshot frames (exact for
    snapshot-covered topics, lossy for fire-and-forget topics like
    load metrics — same stance as JetStream's retention limits).

    publish() may be called from multiple asyncio tasks concurrently
    (each dispatches to a threadpool thread), so _append/_rotate are
    serialized with a lock — interleaved buffered writes would tear
    frames in the journal that restarted routers replay."""

    def __init__(self, root: str, namespace: str,
                 max_bytes: int = 64 * 2**20,
                 grace_seconds: float = 5.0) -> None:
        self.publisher_id = uuid.uuid4().hex
        self._dir = os.path.join(root, namespace)
        os.makedirs(self._dir, exist_ok=True)
        self._generation = 0
        self._max_bytes = max_bytes
        self._grace = grace_seconds
        self._file = open(self._path(), "ab")
        if self._file.tell() == 0:
            # Format preamble: marks this file as CRC-framed (the
            # reference's readers parse a file without it as pre-CRC).
            self._file.write(_JOURNAL_MAGIC)
            self._file.flush()
        self._lock = threading.Lock()
        self._retired: list[tuple[str, float]] = []  # (path, retired_at)
        self.snapshot_fn: Optional[Callable[[], list]] = None

    def _path(self) -> str:
        return os.path.join(
            self._dir, f"{self.publisher_id}.g{self._generation}.log")

    def set_snapshot_fn(self, fn: Callable[[], list]) -> None:
        """fn() -> [(topic, payload), ...] reproducing current state; used
        to seed a rotated journal generation."""
        # Under _lock: _rotate reads snapshot_fn on the to_thread
        # executor while the loop installs it here.
        with self._lock:
            self.snapshot_fn = fn

    async def publish(self, topic: str, payload: Any) -> None:
        data = _journal_pack(topic, payload)
        await asyncio.to_thread(self._append, data)

    def _append(self, data: bytes) -> None:
        with self._lock:
            self._file.write(data)
            self._file.flush()
            if self._file.tell() >= self._max_bytes:
                self._rotate()
            elif self._retired:
                # A publisher that stops rotating must still prune
                # retired generations once their grace expires, or they
                # accumulate on shared storage forever.
                self._prune_retired(time.monotonic())

    def _prune_retired(self, now: float) -> None:
        # Caller holds self._lock.
        keep: list[tuple[str, float]] = []
        for path, at in self._retired:
            if now - at >= self._grace:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            else:
                keep.append((path, at))
        self._retired = keep

    def _rotate(self) -> None:
        # Caller holds self._lock.
        old_path, old_file = self._path(), self._file
        self._generation += 1
        new_file = open(self._path(), "ab")
        if new_file.tell() == 0:
            new_file.write(_JOURNAL_MAGIC)
        if self.snapshot_fn is not None:
            try:
                for topic, payload in self.snapshot_fn():
                    new_file.write(_journal_pack(topic, payload))
            except Exception:  # noqa: BLE001 — a failed snapshot must not
                # lose the stream; fall back to an empty generation (the
                # consumer's gap/bootstrap recovery covers it)
                log.exception("journal snapshot failed during rotation")
        new_file.flush()
        self._file = new_file
        old_file.close()
        # Grace window: retire old_path; unlink only generations that
        # have been retired longer than the grace period, so subscribers
        # can drain tails even across rapid back-to-back rotations.
        now = time.monotonic()
        self._retired.append((old_path, now))
        self._prune_retired(now)
        log.info("journal rotated to generation %d (%s)",
                 self._generation, self.publisher_id)

    async def close(self) -> None:
        with self._lock:
            self._file.close()
            # Nothing needs a superseded generation once the final one
            # holds the snapshot — unlink all retired files so routine
            # restarts never accumulate garbage on shared storage. (A
            # subscriber mid-drain can at worst lose fire-and-forget
            # tail frames of a publisher that is shutting down anyway.)
            self._grace = 0.0
            self._prune_retired(time.monotonic())


class JournalEventSubscriberManager:
    """Tails every publisher log under `<root>/<namespace>/`, replaying
    from offset 0 (full durable history — the restart-recovery property)
    then following live appends. Poll-based like FileDiscovery; KV events
    are already batched by publishers so the poll interval bounds latency,
    not throughput."""

    def __init__(self, root: str, namespace: str, topic_prefix: str,
                 poll_interval: float = 0.05) -> None:
        self._dir = os.path.join(root, namespace)
        self._namespace = namespace
        self._prefix = topic_prefix
        self._poll = poll_interval
        # publisher_id -> (generation, offset)
        self._positions: dict[str, tuple[int, int]] = {}
        self._subscriber = EventSubscriber()
        self._task: Optional[asyncio.Task] = None
        # Corrupt frames skipped via CRC resync, total (mirrors the
        # dynamo_journal_bad_frames_total counter for direct assertion).
        self.bad_frames = 0
        # Partial-tail scan pacing, path -> (eof_seen, eof_scanned): a
        # plausible torn tail is only CRC-scanned for a false "partial"
        # (corrupt length field) once the file STOPS growing — scanning
        # a half-written multi-MB frame on every poll is O(tail²) per
        # poll for nothing — and at most once per stagnant size.
        self._tail_scan: dict[str, tuple[int, int]] = {}

    async def start(self) -> EventSubscriber:
        self._task = asyncio.create_task(self._poll_loop())
        return self._subscriber

    def _read_frames(self, pub: str, gen: int, offset: int,
                     out: list[tuple[str, Any]],
                     bad_acc: list[tuple[str, int, int]]) -> Optional[int]:
        """Read complete frames of `<pub>.g<gen>.log` from offset into
        out (prefix-filtered); returns the new offset, or None if the
        file is gone (rotated away and past its grace window). Corrupt
        frames are skipped (CRC resync) and followed by ONE synthetic
        JOURNAL_RESYNC_TOPIC event — delivered regardless of the topic
        prefix — so consumers re-dump the workers whose state the lost
        frames fed instead of silently diverging. Their count lands in
        `bad_acc`, NOT on the counters: the caller commits it together
        with the position advance (see _commit_bad_frames)."""
        path = os.path.join(self._dir, f"{pub}.g{gen}.log")
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                buf = f.read()
        except OSError:
            self._tail_scan.pop(path, None)
            return None
        bad = [0]

        def _on_bad(k: int) -> None:
            bad[0] += k

        skip = 0
        if offset == 0:
            if (len(buf) < len(_JOURNAL_MAGIC)
                    and _JOURNAL_MAGIC.startswith(buf)):
                return offset  # the preamble is still being written
            if buf.startswith(_JOURNAL_MAGIC):
                skip = len(_JOURNAL_MAGIC)
        end = offset + len(buf)
        st = self._tail_scan.get(path)
        grew = st is None or end > st[0]
        scan_partial = not grew and (st is None or st[1] < end)
        pos = skip
        frames = _journal_read(buf, skip, _on_bad, scan_partial=scan_partial)
        for next_pos, topic, payload in frames:
            pos = next_pos
            if topic is None:
                continue  # consume-to-EOF sentinel (garbage tail)
            if topic.startswith(self._prefix):
                out.append((topic, payload))
        if offset + pos < end:
            # A tail remains unconsumed (partial or not-yet-scanned
            # garbage): remember this EOF so the scan fires exactly once
            # after the file stagnates at it.
            self._tail_scan[path] = (
                end, end if scan_partial else (st[1] if st else 0))
        else:
            self._tail_scan.pop(path, None)
        if bad[0]:
            bad_acc.append((pub, gen, bad[0]))
            out.append((JOURNAL_RESYNC_TOPIC,
                        {"publisher": pub, "generation": gen,
                         "skipped": bad[0]}))
        return offset + pos

    def _commit_bad_frames(
            self, acc: list[tuple[str, int, int]]) -> None:
        """Deferred corruption accounting, applied only when the scan
        commits a publisher's position advance. Counting inside
        _read_frames would re-bump dynamo_journal_bad_frames_total (and
        re-log) on EVERY poll while a transient newest-generation read
        failure keeps positions unadvanced and the same corrupt frames
        keep being re-read."""
        for pub, gen, k in acc:
            self.bad_frames += k
            log.warning(
                "journal corruption: skipped %d bad frame(s) in %s.g%d "
                "(resync signalled)", k, pub, gen)

    def _scan(self) -> list[tuple[str, Any]]:
        """Thread-side: read new frames from every log; returns events."""
        out: list[tuple[str, Any]] = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return out
        files: dict[str, int] = {}
        for name in names:
            if not name.endswith(".log") or ".g" not in name:
                continue
            pub, gen_part = name[:-len(".log")].rsplit(".g", 1)
            try:
                gen = int(gen_part)
            except ValueError:
                continue
            if gen > files.get(pub, -1):
                files[pub] = gen
        for pub, gen in files.items():
            cur_gen, offset = self._positions.get(pub, (-1, 0))
            # Buffer this publisher's frames and emit them only if the
            # newest-generation read succeeds — emitting drained tails
            # while leaving _positions unadvanced (e.g. a transient
            # ESTALE on the newest file over NFS/GCS-fuse) would
            # re-emit the same frames on the next poll.
            pub_out: list[tuple[str, Any]] = []
            pub_bad: list[tuple[str, int, int]] = []
            if gen > cur_gen and cur_gen >= 0:
                # Drain every generation between our position and the
                # newest, in order — the publisher keeps rotated
                # generations on disk for a grace period exactly for
                # this window. A generation already unlinked (we fell
                # past the grace window) is skipped; its state is
                # covered by the newest generation's snapshot frames.
                for g in range(cur_gen, gen):
                    self._read_frames(pub, g,
                                      offset if g == cur_gen else 0,
                                      pub_out, pub_bad)
            if gen > cur_gen:
                offset = 0  # new generation: replay from its start
            new_offset = self._read_frames(pub, gen, offset, pub_out,
                                           pub_bad)
            if new_offset is not None:
                if cur_gen < 0 and pub_out:
                    # First contact with this publisher's log: the
                    # durable-replay property restarted routers rely on.
                    log.info("journal replay: %d events from publisher "
                             "%s (gen %d)", len(pub_out), pub, gen)
                self._positions[pub] = (gen, new_offset)
                out.extend(pub_out)
                self._commit_bad_frames(pub_bad)
        return out

    async def _poll_loop(self) -> None:
        while True:
            try:
                events = await asyncio.to_thread(self._scan)
                for topic, payload in events:
                    self._subscriber._emit(topic, payload)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — keep tailing
                log.exception("journal poll failed")
            await asyncio.sleep(self._poll)

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self._subscriber.close()
