"""Carry the JAX package's params and KV pools across to the port.

`params_from_numpy` takes a params tree as the JAX package builds it (a
nested dict/list of arrays, e.g. `jax.device_get(init_params(key, cfg))`,
or a tree its quantizer produced) and returns the port's `Transformer`
holding the same values, leaf for leaf, in the same layouts. bf16 arrays
arrive as numpy arrays of the `bfloat16` extension dtype; their bits are
reinterpreted, never rounded. Quantized leaves ({"q8", "qs"} and
{"q4", "qs4", "qz4"}) become `Q8Weight` / `Q4Weight`; a v1 int4 leaf stays
uint8 and a v2 leaf int8, so the dtype keeps carrying the layout.

`kv_cache_from_numpy` does the same for the reference's int8 KV pool, a
(values, scales) pair whose lane-broadcast scale rows [L, 2, P, ps, 128]
collapse to the port's one scale per token.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.q4_linear import Q4Weight
from ..ops.q8_linear import Q8Weight
from .config import ModelConfig
from .transformer import KVCache, Transformer


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
            if "q8" in node:
                return Q8Weight(_tensor(node["q8"], dev),
                                _tensor(node["qs"], dev))
            if "q4" in node:
                return Q4Weight(_tensor(node["q4"], dev),
                                _tensor(node["qs4"], dev),
                                _tensor(node["qz4"], dev))
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, dev)

    return Transformer(config, convert(tree))


def kv_cache_from_numpy(kv, *, device: DeviceLike = "cuda") -> KVCache:
    """A JAX int8 KV pool (values [L, 2, P, ps, kh, hd], scales
    [L, 2, P, ps, LANES]) -> the port's (values, scales [L, 2, P, ps]),
    from lane 0, after checking that every lane of a row holds the same
    scale."""
    dev = resolve_device(device)
    values, scales = kv
    scales = np.asarray(scales)
    lane0 = scales[..., 0]
    if not np.array_equal(scales, np.broadcast_to(lane0[..., None],
                                                  scales.shape)):
        raise ValueError("int8 KV scale rows must repeat one value per "
                         "token across their lanes")
    return _tensor(values, dev), _tensor(lane0, dev)
