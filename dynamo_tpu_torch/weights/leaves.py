"""Weight leaves as raw bytes, and their dtype names, in one place.

The JAX package's manifests, arenas and store entries name a leaf's dtype
as numpy does (`"bfloat16"`, `"float32"`, `"int8"`) and hold bf16 leaves as
`ml_dtypes` arrays. This package has no `ml_dtypes`: a leaf is a torch
tensor, and its bytes travel as a uint8 numpy view of its storage (bf16 as
its raw 16-bit words). The names are torch's own dtype names, which equal
numpy's for every dtype a weight tree holds, so the bytes and the names on
the wire equal the JAX package's.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

Leaf = Union[torch.Tensor, np.ndarray]


def dtype_name(leaf: Leaf) -> str:
    """The wire name of a leaf's dtype (`"bfloat16"`, `"float32"`, ...)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(leaf.dtype)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire name; ValueError for a name torch lacks."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown weight dtype {name!r}")
    return dtype


def itemsize(name: str) -> int:
    return torch_dtype(name).itemsize


def to_bytes(leaf: Leaf) -> np.ndarray:
    """A host leaf's bytes as a flat uint8 numpy array (a view where the
    leaf is contiguous). A device tensor is copied to the host first."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.to("cpu")
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def from_bytes(data, dtype: str, shape) -> torch.Tensor:
    """A host tensor of `dtype` and `shape` holding a copy of `data`."""
    words = np.frombuffer(data, dtype=np.uint8).copy()
    return torch.from_numpy(words).view(torch_dtype(dtype)).reshape(
        tuple(shape))

