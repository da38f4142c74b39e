"""Carry the JAX package's params across to the port.

`params_from_numpy` takes a params tree as the JAX package builds it (a
nested dict/list of arrays, e.g. `jax.device_get(init_params(key, cfg))`)
and returns the port's `Transformer` holding the same values, leaf for leaf,
in the same layouts. bf16 arrays arrive as numpy arrays of the `bfloat16`
extension dtype; their bits are reinterpreted, never rounded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .transformer import Transformer

_QUANTIZED_LEAVES = ("q8", "qs", "q4", "qs4", "qz4")


def _tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable copy torch may own
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree: dict, config: ModelConfig, *,
                      device: DeviceLike = "cuda") -> Transformer:
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            if any(k in node for k in _QUANTIZED_LEAVES):
                raise NotImplementedError(
                    "quantized weights (W8A16 / W4A16) are not ported yet")
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, dev)

    return Transformer(config, convert(tree))
