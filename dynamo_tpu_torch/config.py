"""The environment knobs this package reads.

A subset of `dynamo_tpu/runtime/config.py`: the same names, defaults and
parsing, read straight from `os.environ` (no YAML overlay, no new knobs).
"""

from __future__ import annotations

import os
from typing import Callable

_REGISTRY: dict[str, tuple[int, Callable[[str], int], str]] = {
    "DYNT_DECODE_PIPELINE": (
        2, int,
        "Pipelined decode-block dispatches in flight (>1 overlaps the host "
        "readback of block d with block d+1's compute; the tokens chain on "
        "the device)"),
    "DYNT_DECODE_BLOCK": (
        8, int,
        "Decode steps fused into one runner call with no host sync; tokens "
        "stream in blocks of this size"),
    "DYNT_KV_BLOCK_SIZE": (
        16, int,
        "Tokens per KV block (block-hash granularity and paged-KV page size)"),
}


def env(name: str) -> int:
    """Read a registered knob with its declared parser and default."""
    default, parse, _doc = _REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    return parse(raw)
