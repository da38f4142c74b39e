"""The environment knobs this package reads.

A subset of `dynamo_tpu/runtime/config.py`: the same names, defaults and
parsing, read straight from `os.environ` (no YAML overlay, no new knobs).
Each knob carries its own parser, so the registry holds ints and strings.

`DYNT_Q8_MATMUL` and `DYNT_Q4_MATMUL` are not carried over: in the
reference they choose XLA over the Pallas kernel, and on the card the port
always launches its kernel (the plain PyTorch versions run only for CPU
tensors).
"""

from __future__ import annotations

import os
from typing import Any, Callable

_REGISTRY: dict[str, tuple[Any, Callable[[str], Any], str]] = {
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
    "DYNT_Q4_GROUP": (
        "256", str,
        "int4 quantization group (contracted rows per scale/zero row): 256 "
        "| 128 (finer GPTQ/AWQ-convention groups)"),
    "DYNT_Q4_VARIANT": (
        "auto", str,
        "Packed-int4 layout the quantizer emits: auto (v2 wherever K "
        "divides 2*group, else v1) | v1 (half-block per group, uint8) | v2 "
        "(global half-split with signed codes, int8). The matmul dispatches "
        "on the packed dtype; already-quantized trees repack at load"),
}


def env(name: str) -> Any:
    """Read a registered knob with its declared parser and default."""
    default, parse, _doc = _REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    return parse(raw)
