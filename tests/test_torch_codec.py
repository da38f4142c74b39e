"""The port's msgpack and frame codec against the `msgpack` wheel and the
JAX package's codec: byte-equal encodings, round trips, frames read across
the packages, and the same refusals."""

import asyncio
import math
import struct

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import codec as ref_codec
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime import msgpack as port_msgpack


def _ref_pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


scalars = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=300),
    st.binary(max_size=300))
keys = st.one_of(st.text(max_size=20),
                 st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1))
wire = st.recursive(
    scalars,
    lambda inner: st.one_of(st.lists(inner, max_size=20),
                            st.dictionaries(keys, inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(wire)
def test_generated_objects_encode_byte_equal(obj):
    raw = port_msgpack.packb(obj)
    assert raw == _ref_pack(obj)
    assert port_msgpack.unpackb(raw) == _ref_unpack(raw)


BOUNDARIES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -(2 ** 31),
    -(2 ** 31) - 1, -(2 ** 63), 0.0, -0.0, 1.5, math.inf, -math.inf, "",
    "x" * 31, "x" * 32, "x" * 255, "x" * 256, "é" * 40000, b"", b"b" * 255,
    b"b" * 256, b"b" * 70000, [], [0] * 15, [0] * 16, [0] * 70000, {},
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {i: None for i in range(70000)}, [[[[[]]]]], (1, 2),
    bytearray(b"ab"), True, False, None,
]


@pytest.mark.parametrize("obj", BOUNDARIES,
                         ids=lambda o: f"{type(o).__name__}-{len(repr(o))}")
def test_width_boundaries(obj):
    raw = port_msgpack.packb(obj)
    assert raw == _ref_pack(obj)
    assert port_msgpack.unpackb(raw) == _ref_unpack(raw)


def test_float32_and_nan_decode():
    raw = b"\xca" + struct.pack(">f", 0.25)
    assert port_msgpack.unpackb(raw) == _ref_unpack(raw) == 0.25
    nan = port_msgpack.unpackb(_ref_pack(math.nan))
    assert math.isnan(nan) and port_msgpack.packb(math.nan) == _ref_pack(
        math.nan)


@pytest.mark.parametrize("raw", [
    msgpack.packb(msgpack.ExtType(1, b"x")),
    msgpack.packb(msgpack.ExtType(5, b"12345678")),
    msgpack.packb(msgpack.ExtType(7, b"y" * 300)),
], ids=["fixext1", "fixext8", "ext16"])
def test_ext_types_are_refused(raw):
    with pytest.raises(ValueError, match="ext type"):
        port_msgpack.unpackb(raw)


@pytest.mark.parametrize("raw", [b"", b"\x92\x01", b"\xda\x00\x05ab",
                                 b"\x01\x02", b"\xc1"],
                         ids=["empty", "short-array", "short-str", "extra",
                              "never-used"])
def test_malformed_input_is_refused(raw):
    with pytest.raises(ValueError):
        _ref_unpack(raw)
    with pytest.raises(ValueError):
        port_msgpack.unpackb(raw)


def test_unpackable_objects_are_refused():
    for obj in (object(), {1, 2}, 2 ** 64, -(2 ** 63) - 1):
        with pytest.raises((TypeError, OverflowError)) as ref:
            _ref_pack(obj)
        with pytest.raises(ref.type):
            port_msgpack.packb(obj)


FRAMES = [
    ({"t": "req", "i": 1, "s": "dynamo/backend/generate/7", "h": {}},
     {"request_id": "r", "token_ids": [1, 2, 3],
      "sampling": {"temperature": 0.0, "seed": None}}),
    ({"t": "data", "i": 2 ** 40}, {"t": [5], "f": "length", "p": 3}),
    ({"t": "end", "i": 3}, None),
    ({"t": "err", "i": 4, "e": "boom", "c": "handler_error"}, None),
    ({"t": "cancel", "i": 5}, None),
    ({"t": "ping", "i": 6}, None),
]


def _read(read_frame, data: bytes):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        out = []
        while True:
            frame = await read_frame(reader)
            if frame is None:
                return out
            out.append(frame)

    return asyncio.run(asyncio.wait_for(go(), 10))


@pytest.mark.parametrize("header,body", FRAMES,
                         ids=[h["t"] for h, _ in FRAMES])
def test_frames_cross_the_packages(header, body):
    payload = b"" if body is None else codec.pack_body(body)
    assert payload == (b"" if body is None else ref_codec.pack_body(body))
    port_frame = codec.encode_frame(header, payload)
    assert port_frame == ref_codec.encode_frame(header, payload)
    for read_frame in (ref_codec.read_frame, codec.read_frame):
        (got_header, got_payload), = _read(read_frame, port_frame)
        assert got_header == header and got_payload == payload
        if body is not None:
            assert codec.unpack_body(got_payload) == body
            assert ref_codec.unpack_body(got_payload) == body


def test_a_stream_of_frames_reads_in_order():
    data = b"".join(ref_codec.encode_frame(h, b"" if b is None else
                                           ref_codec.pack_body(b))
                    for h, b in FRAMES)
    assert ([h for h, _ in _read(codec.read_frame, data)]
            == [h for h, _ in FRAMES])


@pytest.mark.parametrize("prefix", [
    struct.pack(">II", codec.MAX_FRAME + 1, 4),
    struct.pack(">II", 10, 11),
], ids=["oversized", "header-longer-than-frame"])
def test_oversized_and_corrupt_frames_are_refused(prefix):
    assert codec.MAX_FRAME == ref_codec.MAX_FRAME
    for read_frame in (ref_codec.read_frame, codec.read_frame):
        with pytest.raises(ValueError, match="oversized/corrupt frame"):
            _read(read_frame, prefix + b"\x00" * 16)


def test_truncated_frames_read_as_eof():
    frame = codec.encode_frame({"t": "end", "i": 1})
    for cut in (3, 8, len(frame) - 1):
        assert _read(ref_codec.read_frame, frame[:cut]) == []
        assert _read(codec.read_frame, frame[:cut]) == []
