"""A small msgpack codec for the request plane's wire objects.

The JAX package frames its request plane with the `msgpack` wheel; this
package depends on torch, numpy and the standard library only. This covers
the types that cross the wire: nil, bool, int (fixint, int/uint 8-64),
float (float64 out; float32 and float64 in), str, bin, array and map.

`packb(obj)` is byte-equal to `msgpack.packb(obj, use_bin_type=True)`;
`unpackb(data)` returns what `msgpack.unpackb(data, raw=False,
strict_map_key=False)` returns. Ext types are refused with ValueError.
"""

from __future__ import annotations

import struct
from typing import Any

_B = struct.Struct(">B").pack
_H = struct.Struct(">H").pack
_I = struct.Struct(">I").pack
_Q = struct.Struct(">Q").pack
_b = struct.Struct(">b").pack
_h = struct.Struct(">h").pack
_i = struct.Struct(">i").pack
_q = struct.Struct(">q").pack
_d = struct.Struct(">d").pack


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        if n <= 0xFF:
            out += b"\xcc" + _B(n)
        elif n <= 0xFFFF:
            out += b"\xcd" + _H(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xce" + _I(n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q(n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -0x80:
        out += b"\xd0" + _b(n)
    elif n >= -0x8000:
        out += b"\xd1" + _h(n)
    elif n >= -0x80000000:
        out += b"\xd2" + _i(n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + _q(n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: bytearray) -> None:
    """Length header: the fix form below `fix_max`, else 8/16/32-bit forms
    (`codes` lists their type bytes; str and bin have an 8-bit form, array
    and map do not)."""
    if fix_max and n < fix_max:
        out.append(fix | n)
    elif len(codes) == 3 and n <= 0xFF:
        out += codes[0:1] + _B(n)
    elif n <= 0xFFFF:
        out += codes[-2:-1] + _H(n)
    elif n <= 0xFFFFFFFF:
        out += codes[-1:] + _I(n)
    else:
        raise ValueError(f"object too large for msgpack ({n})")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + _d(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, b"\xd9\xda\xdb", out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), 0, 0, b"\xc4\xc5\xc6", out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\xdc\xdd", out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\xde\xdf", out)
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# Fixed-width scalars by type byte: (struct format, size).
_SCALARS = {
    0xCA: (struct.Struct(">f"), 4), 0xCB: (struct.Struct(">d"), 8),
    0xCC: (struct.Struct(">B"), 1), 0xCD: (struct.Struct(">H"), 2),
    0xCE: (struct.Struct(">I"), 4), 0xCF: (struct.Struct(">Q"), 8),
    0xD0: (struct.Struct(">b"), 1), 0xD1: (struct.Struct(">h"), 2),
    0xD2: (struct.Struct(">i"), 4), 0xD3: (struct.Struct(">q"), 8),
}
# Length-prefixed kinds: type byte -> (kind, width of the length field).
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_EXT = {0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8}


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def value(self) -> Any:
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return self._str(code & 0x1F)
        if 0x90 <= code <= 0x9F:
            return self._array(code & 0x0F)
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if code == 0xC0:
            return None
        if code == 0xC2:
            return False
        if code == 0xC3:
            return True
        scalar = _SCALARS.get(code)
        if scalar is not None:
            fmt, size = scalar
            return fmt.unpack(self.take(size))[0]
        sized = _SIZED.get(code)
        if sized is not None:
            kind, width = sized
            n = int.from_bytes(self.take(width), "big")
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self._str(n)
            return self._array(n) if kind == "array" else self._map(n)
        if code in _EXT:
            raise ValueError(f"msgpack ext type 0x{code:02x} is not supported")
        raise ValueError(f"invalid msgpack type byte 0x{code:02x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    reader = _Reader(memoryview(data) if not isinstance(data, bytes)
                     else data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("Unpack failed: extra data after the object")
    return obj
