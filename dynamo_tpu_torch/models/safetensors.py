"""The safetensors file format, read and written with torch and the standard
library.

Stands in for the `safetensors` package, which the JAX package's checkpoint
module calls (`safe_open`, `save_file`) and the card's machine lacks. A
file is an 8-byte little-endian header length N, N bytes of JSON mapping
each tensor's name to {"dtype", "shape", "data_offsets": [begin, end]}
(offsets into the byte buffer that follows the header) plus an optional
"__metadata__" of strings, then the raw little-endian buffers.

`SafeFile` reads the header and hands out each tensor as a
`torch.frombuffer` view over a map of that tensor's bytes alone: nothing is
copied until the caller copies (a cast, a reshape into a new layout, a move
to the card), and the map goes when the view does, so a loader that moves
tensors one at a time keeps one tensor's pages mapped, not the file's. BF16
is read as int16 and viewed as `torch.bfloat16`, bit for bit. `save_file` writes tensors one at
a time, each copied to the host and written, so a model on the card is
never whole in host memory.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Iterable

import torch

# safetensors dtype name -> torch dtype, and the bytes of one element
DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# The largest header the format allows (the reference implementation's
# limit), so a corrupt length fails before a huge read.
MAX_HEADER = 100 * 1024 * 1024


class SafetensorsError(ValueError):
    """A file that is not valid safetensors, or a dtype this reader does not
    implement."""


class SafeFile:
    """One safetensors file. `keys()` lists its tensors; `get(name)`
    returns one as a view over its own copy-on-write map (a write into it
    changes the process's page, never the file), valid after `close()`.
    Use as a context manager, or `close()`."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._file = open(self.path, "rb")
        try:
            size = os.fstat(self._file.fileno()).st_size
            head = self._file.read(8)
            if len(head) < 8:
                raise SafetensorsError(f"{self.path}: shorter than the "
                                       "8-byte header length")
            (n,) = struct.unpack("<Q", head)
            if n > MAX_HEADER or 8 + n > size:
                raise SafetensorsError(f"{self.path}: header length {n} "
                                       f"does not fit a {size}-byte file")
            try:
                header = json.loads(self._file.read(n))
            except (UnicodeDecodeError, ValueError) as exc:
                raise SafetensorsError(
                    f"{self.path}: header is not JSON ({exc})") from None
            if not isinstance(header, dict):
                raise SafetensorsError(f"{self.path}: header is not a JSON "
                                       "object")
            self.metadata = header.pop("__metadata__", None)
            self._data_start = 8 + n
            self._data_len = size - self._data_start
            self._entries = {}
            for name, entry in header.items():
                self._entries[name] = self._check(name, entry)
        except BaseException:
            self._file.close()
            raise

    def _check(self, name: str, entry) -> tuple:
        try:
            dtype_name = entry["dtype"]
            shape = tuple(int(d) for d in entry["shape"])
            begin, end = (int(o) for o in entry["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise SafetensorsError(
                f"{self.path}: malformed entry for {name!r}: {entry!r}"
            ) from None
        if dtype_name not in DTYPES:
            raise SafetensorsError(
                f"{self.path}: tensor {name!r} has dtype {dtype_name!r}, "
                f"which this reader does not implement "
                f"(have {sorted(DTYPES)})")
        dtype = DTYPES[dtype_name]
        count = 1
        for d in shape:
            if d < 0:
                raise SafetensorsError(f"{self.path}: tensor {name!r} has "
                                       f"shape {shape}")
            count *= d
        itemsize = torch.empty(0, dtype=dtype).element_size()
        if not 0 <= begin <= end <= self._data_len \
                or end - begin != count * itemsize:
            raise SafetensorsError(
                f"{self.path}: tensor {name!r} ({dtype_name} {shape}) has "
                f"offsets [{begin}, {end}] in a {self._data_len}-byte buffer")
        return dtype, shape, begin, end

    def keys(self) -> list[str]:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        if name not in self._entries:
            raise KeyError(name)
        dtype, shape, begin, end = self._entries[name]
        if begin == end:
            return torch.empty(shape, dtype=dtype)
        start = self._data_start + begin
        aligned = start // mmap.ALLOCATIONGRANULARITY \
            * mmap.ALLOCATIONGRANULARITY
        view = mmap.mmap(self._file.fileno(), self._data_start + end - aligned,
                         access=mmap.ACCESS_COPY, offset=aligned)
        # bf16 has no buffer-protocol code: read it as int16, view it back
        read_as = torch.int16 if dtype == torch.bfloat16 else dtype
        itemsize = torch.empty(0, dtype=read_as).element_size()
        flat = torch.frombuffer(view, dtype=read_as,
                                count=(end - begin) // itemsize,
                                offset=start - aligned)
        return flat.view(dtype).reshape(shape)

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_file(tensors: dict, path: str) -> None:
    """Write `tensors` (name -> tensor on any device) to `path`, in the
    order given. The header is padded with spaces to a multiple of 8 and
    `__metadata__` is {"format": "pt"}."""
    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise SafetensorsError(f"{name}: dtype {t.dtype} has no "
                                   "safetensors name here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            _write_tensor(f, t)


def _write_tensor(f, t: torch.Tensor) -> None:
    host = t.detach().to("cpu").contiguous()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    if host.numel():
        f.write(memoryview(host.numpy()).cast("B"))


def write_shards(tensors: Iterable[tuple[str, torch.Tensor]], directory: str,
                 max_shard_bytes: int) -> dict[str, str]:
    """Write (name, tensor) pairs into `model-0000i-of-0000n.safetensors`
    shards of at most `max_shard_bytes` each (a tensor larger than that
    gets a shard of its own), plus `model.safetensors.index.json`. Pairs
    are consumed one shard at a time, so a caller that yields tensors lazily
    holds one shard's worth at most. Returns the weight map."""
    os.makedirs(directory, exist_ok=True)
    shards: list[list[str]] = []
    weight_map: dict[str, str] = {}
    total = 0
    pending: dict[str, torch.Tensor] = {}
    pending_bytes = 0
    tmp_names: list[str] = []

    def flush() -> None:
        nonlocal pending, pending_bytes
        if not pending:
            return
        tmp = os.path.join(directory, f".shard-{len(tmp_names)}.tmp")
        save_file(pending, tmp)
        tmp_names.append(tmp)
        shards.append(list(pending))
        pending, pending_bytes = {}, 0

    for name, t in tensors:
        n = t.numel() * t.element_size()
        if pending and pending_bytes + n > max_shard_bytes:
            flush()
        pending[name] = t
        pending_bytes += n
        total += n
    flush()
    count = len(shards)
    for i, (tmp, names) in enumerate(zip(tmp_names, shards)):
        final = f"model-{i + 1:05d}-of-{count:05d}.safetensors"
        os.replace(tmp, os.path.join(directory, final))
        weight_map.update({name: final for name in names})
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return weight_map
