"""Wire codec for the request plane.

Port of `dynamo_tpu/runtime/codec.py`, byte for byte on the wire, built on
this package's msgpack (`runtime/msgpack.py`). Every request-plane message
is one length-prefixed frame:

    [u32 big-endian total_len][u32 header_len][msgpack header][payload bytes]

Header fields (short keys; this is a hot path):
    t   frame type: req | data | end | err | cancel | ping | pong
    i   request id (u64)
    s   subject ("namespace/component/endpoint"), req only
    h   user headers dict, req only
    e   error string, err only

The payload is the msgpack of the request/response body for `req`/`data`.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Optional, Tuple

from . import msgpack

MAX_FRAME = 1 << 30  # 1 GiB hard cap

_LEN = struct.Struct(">II")


def encode_frame(header: dict, payload: bytes = b"") -> bytes:
    head = msgpack.packb(header)
    return _LEN.pack(len(head) + len(payload) + 4, len(head)) + head + payload


def pack_body(body: Any) -> bytes:
    return msgpack.packb(body)


def unpack_body(payload: bytes) -> Any:
    return msgpack.unpackb(payload)


async def read_frame(
    reader: asyncio.StreamReader,
) -> Optional[Tuple[dict, bytes]]:
    """Read one frame; returns None on clean EOF."""
    try:
        prefix = await reader.readexactly(8)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    total_len, header_len = _LEN.unpack(prefix)
    if total_len > MAX_FRAME or header_len > total_len:
        raise ValueError(
            f"oversized/corrupt frame: total={total_len} header={header_len}")
    try:
        rest = await reader.readexactly(total_len - 4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    header = msgpack.unpackb(rest[:header_len])
    return header, rest[header_len:]


def write_frame(writer: asyncio.StreamWriter, header: dict,
                payload: bytes = b"") -> None:
    writer.write(encode_frame(header, payload))
