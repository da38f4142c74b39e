"""Token-sequence -> block-hash identity, in pure Python.

Port of `dynamo_tpu/tokens/__init__.py`. KV-cache reuse keys on *chained*
hashes of fixed-size token blocks: block i's hash seeds block i+1's hash, so
a block hash identifies the whole token prefix up to and including that
block. Each block is XXH64 over the little-endian u32 token bytes, seeded
with the previous block's hash. Partial trailing blocks are never hashed.

The JAX package hashes with the `xxhash` wheel or its C++ extension; this
package may use neither, so XXH64 is written out here. The hashes are
bit-identical to the JAX package's, so prefix-cache identities agree across
the two packages.
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional, Sequence

# Seed for the first block in a sequence (same constant as the JAX package).
INITIAL_SEED = 0xD3A10_C0DE

_MASK64 = 0xFFFFFFFFFFFFFFFF

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _MASK64
    return (_rotl(acc, 31) * _P1) & _MASK64


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _MASK64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` as an unsigned 64-bit int (the reference algorithm,
    same result as `xxhash.xxh64_intdigest(data, seed)`)."""
    seed &= _MASK64
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _MASK64
        v2 = (seed + _P2) & _MASK64
        v3 = seed
        v4 = (seed - _P1) & _MASK64
        while i + 32 <= n:
            a, b, c, d = struct.unpack_from("<4Q", data, i)
            v1 = _round(v1, a)
            v2 = _round(v2, b)
            v3 = _round(v3, c)
            v4 = _round(v4, d)
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _MASK64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + _P5) & _MASK64
    h = (h + n) & _MASK64
    while i + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, i)
        h ^= _round(0, lane)
        h = (_rotl(h, 27) * _P1 + _P4) & _MASK64
        i += 8
    if i + 4 <= n:
        (word,) = struct.unpack_from("<I", data, i)
        h ^= (word * _P1) & _MASK64
        h = (_rotl(h, 23) * _P2 + _P3) & _MASK64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _MASK64
        h = (_rotl(h, 11) * _P1) & _MASK64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _MASK64
    h ^= h >> 29
    h = (h * _P3) & _MASK64
    h ^= h >> 32
    return h


def lora_id_of(name: Optional[str]) -> Optional[int]:
    """Stable numeric identity for a LoRA adapter name, used to salt block
    hashes (the same prompt under different adapters has different KV)."""
    if not name:
        return None
    return xxh64(name.encode("utf-8"))


def hash_block(tokens: Sequence[int], seed: int) -> int:
    """Hash one full block of token ids with a chaining seed."""
    buf = struct.pack(f"<{len(tokens)}I", *(int(t) for t in tokens))
    return xxh64(buf, seed & _MASK64)


def _initial_seed(lora_id: Optional[int]) -> int:
    if lora_id is None:
        return INITIAL_SEED
    return (INITIAL_SEED ^ (lora_id * 0x9E3779B97F4A7C15)) & _MASK64


def compute_block_hashes(
    tokens: Sequence[int],
    block_size: int,
    *,
    lora_id: Optional[int] = None,
) -> list[int]:
    """Chained hashes for every *full* block of `tokens`; `lora_id` perturbs
    the initial seed so adapters never share KV identity."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    seed = _initial_seed(lora_id)
    out: list[int] = []
    for start in range(0, len(tokens) - block_size + 1, block_size):
        seed = hash_block(tokens[start : start + block_size], seed)
        out.append(seed)
    return out


class TokenBlockSequence:
    """Incremental block hasher for a growing token sequence: newly
    completed blocks get hashes without re-hashing the prefix."""

    def __init__(self, block_size: int, lora_id: Optional[int] = None) -> None:
        self.block_size = block_size
        self._tokens: list[int] = []
        self._hashes: list[int] = []
        self._seed = _initial_seed(lora_id)

    def extend(self, tokens: Iterable[int]) -> list[int]:
        """Append tokens; returns hashes of any newly completed blocks."""
        self._tokens.extend(int(t) for t in tokens)
        n_complete = len(self._tokens) // self.block_size
        new_hashes: list[int] = []
        seed = self._seed
        for s in range(len(self._hashes) * self.block_size,
                       n_complete * self.block_size, self.block_size):
            seed = hash_block(self._tokens[s : s + self.block_size], seed)
            new_hashes.append(seed)
        if new_hashes:
            self._seed = new_hashes[-1]
            self._hashes.extend(new_hashes)
        return new_hashes

    @property
    def tokens(self) -> list[int]:
        return self._tokens

    @property
    def block_hashes(self) -> list[int]:
        return list(self._hashes)
