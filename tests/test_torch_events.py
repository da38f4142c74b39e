"""The port's event plane against the JAX package's: the mem bus, the
journal (byte-equal frames, read across packages, rotation with a snapshot,
a torn tail, a corrupt frame) and the ZMQ transport, which the port speaks
as ZMTP 3.0 on asyncio streams, against pyzmq / libzmq in both directions
(prefix filters, a late subscriber, a slow subscriber that must not block
the publisher). Payloads are drawn from a numpy seed. Binds 127.0.0.1
only, spawns no subprocess."""

import asyncio
import os
import time
import uuid

import numpy as np
import pytest
import zmq
import zmq.asyncio

from dynamo_tpu.runtime import discovery as ref_discovery
from dynamo_tpu.runtime import events as ref_events
from dynamo_tpu_torch.runtime import discovery, events, zmtp
from dynamo_tpu_torch.runtime.msgpack import unpackb

W = 10.0  # bound on each wait


def _payloads(seed: int, n: int = 40) -> list[tuple[str, object]]:
    """(topic, payload) pairs shaped like KV events, load metrics and
    snapshots: u64 hashes, None parents, floats, bools, nested lists."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            out.append(("kv_events", {
                "w": int(rng.integers(2**63)), "e": i, "d": 0,
                "s": {"b": [int(h) for h in rng.integers(
                    0, 2**64, int(rng.integers(1, 70)), dtype=np.uint64)],
                    "p": None if rng.random() < 0.3 else int(
                        rng.integers(2**63))}}))
        elif kind == 1:
            out.append(("load_metrics", {
                "worker_id": int(rng.integers(2**63)), "dp_rank": 0,
                "active_blocks": int(rng.integers(2048)),
                "kv_usage": float(rng.random()), "draining": False}))
        else:
            out.append(("kv_snapshot", {
                "worker_id": 5, "last_event_id": i,
                "blocks": [[None, 1], [1, int(rng.integers(2**63))]]}))
    return out


def test_mem_plane_filters_by_prefix(run):
    async def go():
        plane = events.MemEventPlane(cluster=uuid.uuid4().hex)
        sub = plane.subscribe("kv")
        everything = plane.subscribe("")
        pub = plane.publisher()
        for topic, payload in _payloads(1, 9):
            await pub.publish(topic, payload)
        got = [await asyncio.wait_for(sub.__anext__(), W) for _ in range(6)]
        alltopics = [(await asyncio.wait_for(everything.__anext__(), W))[0]
                     for _ in range(9)]
        await sub.close()
        return got, alltopics

    got, alltopics = run(go())
    want = [p for p in _payloads(1, 9) if p[0].startswith("kv")]
    assert got == want
    assert alltopics == [t for t, _ in _payloads(1, 9)]


# -- the journal ---------------------------------------------------------------


def _files(root: str, namespace: str) -> list[bytes]:
    """The journal files' bytes, by generation."""
    d = os.path.join(root, namespace)
    names = sorted(os.listdir(d), key=lambda n: int(n.rsplit(".g", 1)[1][:-4]))
    out = []
    for name in names:
        with open(os.path.join(d, name), "rb") as f:
            out.append(f.read())
    return out


def test_journal_frames_and_rotation_are_byte_equal(run, tmp_path):
    """Both packages write the same bytes for the same publishes: the
    preamble, every frame, and each rotated generation seeded with the same
    snapshot."""
    snapshot = [("kv_snapshot", {"worker_id": 9, "last_event_id": 3,
                                 "blocks": [[None, 11], [11, 12]]})]

    async def go():
        mine = events.JournalEventPublisher(str(tmp_path / "port"), "ns",
                                            max_bytes=2000)
        theirs = ref_events.JournalEventPublisher(str(tmp_path / "ref"), "ns",
                                                  max_bytes=2000)
        for pub in (mine, theirs):
            pub.set_snapshot_fn(lambda: snapshot)
            for topic, payload in _payloads(2):
                await pub.publish(topic, payload)
        return mine, theirs

    mine, theirs = run(go())
    port_files = _files(str(tmp_path / "port"), "ns")
    assert port_files == _files(str(tmp_path / "ref"), "ns")
    assert len(port_files) >= 3  # rotated at least twice
    assert all(f.startswith(b"DYNJRNL1") for f in port_files)
    run(mine.close())
    run(theirs.close())


def _scan_all(manager) -> list:
    return [(t, p) for t, p in manager._scan()]


def test_journals_are_read_across_packages(run, tmp_path):
    """A journal the port writes is what the reference's subscriber reads,
    and the reverse, prefix filter included."""
    sent = _payloads(3)

    async def go():
        out = {}
        for writer, reader in ((events, ref_events), (ref_events, events)):
            root = str(tmp_path / writer.__name__.split(".")[0])
            pub = writer.JournalEventPublisher(root, "ns", max_bytes=3000)
            pub.set_snapshot_fn(lambda: sent[2:3])
            sub = reader.JournalEventSubscriberManager(root, "ns", "kv")
            for i, (topic, payload) in enumerate(sent):
                await pub.publish(topic, payload)
                if i % 7 == 0:
                    out.setdefault(writer, []).extend(_scan_all(sub))
            out[writer].extend(_scan_all(sub))
            await pub.close()
        return out

    out = run(go())
    want_live = [p for p in sent if p[0].startswith("kv")]
    for got in out.values():
        # each rotation replays the snapshot frame at the new generation's
        # head; the live frames arrive in order between them
        live = [p for p in got if p != sent[2]]
        assert live == [p for p in want_live if p != sent[2]]
        assert got.count(sent[2]) >= 2
    assert out[events] == out[ref_events]


def test_journal_torn_tail_and_corrupt_frame_as_the_reference(tmp_path):
    """A frame cut mid-body waits for its remainder; a frame whose bytes
    were damaged is skipped with one JOURNAL_RESYNC_TOPIC event. The port's
    subscriber and the reference's read the same file the same way."""
    root = str(tmp_path)
    d = os.path.join(root, "ns")
    os.makedirs(d)
    frames = [events._journal_pack(t, p) for t, p in _payloads(4, 12)]
    assert frames == [ref_events._journal_pack(t, p)
                      for t, p in _payloads(4, 12)]
    path = os.path.join(d, "pubid.g0.log")
    body = b"DYNJRNL1" + b"".join(frames[:5])
    torn = frames[5][: len(frames[5]) // 2]
    with open(path, "wb") as f:
        f.write(body + torn)
    mine = events.JournalEventSubscriberManager(root, "ns", "")
    theirs = ref_events.JournalEventSubscriberManager(root, "ns", "")
    steps = []
    steps.append((_scan_all(mine), _scan_all(theirs)))
    with open(path, "ab") as f:  # the rest of the torn frame, then frames
        f.write(frames[5][len(torn):] + b"".join(frames[6:8]))
    steps.append((_scan_all(mine), _scan_all(theirs)))
    bad = bytearray(frames[8])
    bad[12] ^= 0xFF  # a body byte: the CRC no longer matches
    with open(path, "ab") as f:
        f.write(bytes(bad) + b"".join(frames[9:]))
    steps.append((_scan_all(mine), _scan_all(theirs)))
    for a, b in steps:
        assert a == b
    assert [len(a) for a, _ in steps] == [5, 3, 4]
    resync = steps[2][0][-1]
    assert resync == (events.JOURNAL_RESYNC_TOPIC,
                      {"publisher": "pubid", "generation": 0, "skipped": 1})
    assert mine.bad_frames == theirs.bad_frames == 1
    assert [p for p in steps[2][0][:3]] == _payloads(4, 12)[9:]


# -- ZMQ: ZMTP against libzmq --------------------------------------------------


async def _until(pred, what: str):
    deadline = time.monotonic() + W
    while not pred():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.01)


def test_port_publisher_to_pyzmq_subscriber(run):
    """Prefix filters (two subscriptions, then one cancelled), a message
    sent before the subscription lost, short and long frames."""

    async def go():
        pub = zmtp.ZmtpPublisher("127.0.0.1")
        await pub.start()
        pub.send([b"kv_events", b"early"])  # no subscriber yet: dropped
        ctx = zmq.asyncio.Context()
        sub = ctx.socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, b"kv_e")
        sub.setsockopt(zmq.SUBSCRIBE, b"load")
        sub.connect(pub.address)
        await _until(lambda: sum(len(p.subscriptions)
                                 for p in pub.peers) == 2, "subscriptions")
        big = bytes(range(256)) * 40
        for topic, body in ((b"kv_events", b"a"), (b"kv_snapshot", b"b"),
                            (b"load_metrics", big), (b"other", b"c")):
            pub.send([topic, body])
        got = [await asyncio.wait_for(sub.recv_multipart(), W)
               for _ in range(2)]
        sub.setsockopt(zmq.UNSUBSCRIBE, b"load")
        await _until(lambda: sum(len(p.subscriptions)
                                 for p in pub.peers) == 1, "cancel")
        pub.send([b"load_metrics", b"d"])
        pub.send([b"kv_events", b"e"])
        got.append(await asyncio.wait_for(sub.recv_multipart(), W))
        sub.close(0)
        ctx.term()
        await pub.close()
        return got

    got = run(go())
    assert got == [[b"kv_events", b"a"],
                   [b"load_metrics", bytes(range(256)) * 40],
                   [b"kv_events", b"e"]]


def test_pyzmq_publisher_to_port_subscriber(run):
    async def go():
        ctx = zmq.asyncio.Context()
        pub = ctx.socket(zmq.PUB)
        port = pub.bind_to_random_port("tcp://127.0.0.1")
        got = []
        sub = zmtp.ZmtpSubscriber(f"tcp://127.0.0.1:{port}", [b"kv"],
                                  got.append)
        await asyncio.wait_for(sub.connected.wait(), W)
        big = os.urandom(70000)
        deadline = time.monotonic() + W
        while not got:  # libzmq applies the subscription asynchronously
            assert time.monotonic() < deadline
            await pub.send_multipart([b"kv_probe", b""])
            await asyncio.sleep(0.02)
        got.clear()
        for frames in ([b"load", b"x"], [b"kv_events", big],
                       [b"kv_snapshot", b"y"]):
            await pub.send_multipart(frames)
        await _until(lambda: len(got) == 2, "two messages")
        await sub.close()
        pub.close(0)
        ctx.term()
        return got, big

    got, big = run(go())
    assert got == [[b"kv_events", big], [b"kv_snapshot", b"y"]]


def test_slow_subscriber_does_not_block_the_publisher(run):
    """A subscriber that handshakes, subscribes and then never reads: the
    publisher keeps sending at once, queues at most `hwm` messages for it
    and drops the rest."""

    async def go():
        pub = zmtp.ZmtpPublisher("127.0.0.1", hwm=1000)
        await pub.start()
        host, port = pub.address.removeprefix("tcp://").split(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        await zmtp.handshake(reader, writer, "SUB", ("PUB",))
        writer.write(zmtp.encode_frame(b"\x01kv"))
        await writer.drain()
        await _until(lambda: pub.subscribed() == 1, "subscription")
        payload = os.urandom(16384)
        t0 = time.perf_counter()
        for _ in range(5000):
            pub.send([b"kv_events", payload])
        took = time.perf_counter() - t0
        await asyncio.sleep(0.2)  # let the writer fill the socket
        (peer,) = pub.peers
        out = (took, pub.dropped(), len(peer.queue))
        writer.close()
        await pub.close()
        return out

    took, dropped, queued = run(go())
    assert took < 2.0
    assert dropped >= 5000 - 1000 - 200  # the socket buffers hold a few
    assert queued <= 1000


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_zmq_event_plane_across_packages(run, tmp_path, direction):
    """The event plane as each runtime builds it: a publisher advertised in
    file discovery under a lease, a subscriber manager that finds it there
    and connects — one package on each side."""
    root = str(tmp_path)

    async def go():
        port_disc = discovery.FileDiscovery(root, poll_interval=0.05)
        ref_disc = ref_discovery.FileDiscovery(root, poll_interval=0.05)
        await port_disc.start()
        await ref_disc.start()
        if direction == "port_to_ref":
            lease = await port_disc.create_lease(120.0)
            pub = events.ZmqEventPublisher("ns", port_disc, lease)
            manager = ref_events.ZmqEventSubscriberManager(
                "ns", ref_disc, "kv")
        else:
            lease = await ref_disc.create_lease(120.0)
            pub = ref_events.ZmqEventPublisher("ns", ref_disc, lease)
            manager = events.ZmqEventSubscriberManager("ns", port_disc, "kv")
        sub = await manager.start()
        await pub.advertise()
        sent = _payloads(6, 12)
        # PUB/SUB joins are asynchronous: probe until one probe arrives
        deadline = time.monotonic() + W
        while True:
            await pub.publish("kv_probe", {"n": 1})
            try:
                topic, _ = await asyncio.wait_for(sub.__anext__(), 0.1)
                break
            except asyncio.TimeoutError:
                assert time.monotonic() < deadline, "never joined"
        for topic, payload in sent:
            await pub.publish(topic, payload)
        want = [p for p in sent if p[0].startswith("kv")]
        got = []
        while len(got) < len(want):
            item = await asyncio.wait_for(sub.__anext__(), W)
            if item[0] != "kv_probe":
                got.append(item)
        await pub.close()
        if direction == "ref_to_port":
            # the advertisement's delete drops the connection
            await _until(lambda: not manager._connections, "disconnect")
        await manager.close()
        left = await port_disc.get_prefix("v1/events/")
        await port_disc.close()
        await ref_disc.close()
        return got, want, left

    got, want, left = run(go())
    assert got == want
    assert left == {}  # close() withdrew the advertisement


def test_frames_and_greeting_are_zmtp_3():
    g = zmtp.GREETING
    assert len(g) == 64 and g[0] == 0xFF and g[9] == 0x7F
    assert g[10:12] == b"\x03\x00" and g[12:16] == b"NULL" and g[32] == 0
    assert zmtp.encode_frame(b"ab", more=True) == b"\x01\x02ab"
    long = zmtp.encode_frame(b"x" * 300)
    assert long[:9] == b"\x02" + (300).to_bytes(8, "big")
    name, data = zmtp.parse_command(zmtp.encode_ready("SUB")[2:])
    assert name == "READY"
    assert zmtp.parse_properties(data) == {"socket-type": b"SUB"}
    assert unpackb(events._journal_pack("t", [1, None])[8:]) == {
        "t": "t", "p": [1, None]}
