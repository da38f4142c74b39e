"""Portable KV block layout descriptors and TP-mismatch bridging.

Port of `dynamo_tpu/block_manager/layout.py`. `BlockLayoutSpec` is the
reference's descriptor field for field (its wire dict compares equal), and
the universal block is the page-major bundle `[n_blocks, L, 2, page_size,
kv_heads, head_dim]` of `ops.block_copy.gather_kv_blocks`, or, for an int8
pool, the packed uint8 row of `gather_kv_blocks_q8` (value bytes, then the
bf16 scale rows over `scale_lanes` lanes). A shard holds a contiguous
kv-head range, so bridging a TP mismatch is a reindex over the kv-head axis.

The reference bridges numpy bundles; numpy has no bfloat16 without
`ml_dtypes`, so here `reslice` and `assemble` take and return CPU torch
tensors (any dtype, bf16 too) and give the reference's bytes. The dtype
names stay numpy's (`llm.kv_transfer.TORCH_DTYPES` maps them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..llm.kv_transfer import TORCH_DTYPES


@dataclasses.dataclass(frozen=True)
class BlockLayoutSpec:
    """Geometry + shard placement of a paged-KV pool, serializable for the
    wire (the reference's SerializedNixlBlockLayout equivalent)."""

    n_layers: int
    total_kv_heads: int  # model-wide head count
    head_dim: int
    page_size: int
    dtype: str  # numpy dtype name (uint8 for packed quantized blocks)
    kv_dims: int = 2  # 2 for separate K/V stacks, 1 for an MLA latent cache
    kv_head_start: int = 0  # first head this shard holds
    kv_head_count: Optional[int] = None  # None = all heads (unsharded)
    # Quantized pools (kv_dtype "int8"): tier blocks travel as PACKED uint8
    # bytes, int8 values then lane-broadcast bf16 scale rows, bit-exact
    # across offload and onboard. scale_lanes is the scale-row width.
    kv_dtype: str = "model"
    scale_lanes: int = 0

    def __post_init__(self) -> None:
        if self.kv_head_count is None:
            object.__setattr__(self, "kv_head_count", self.total_kv_heads)
        if self.kv_head_start + self.kv_head_count > self.total_kv_heads:
            raise ValueError("shard exceeds total kv heads")
        if self.kv_dtype == "int8":
            if self.scale_lanes <= 0:
                raise ValueError("int8 layout needs scale_lanes > 0")
            # Packed bytes are opaque: the arena dtype is uint8 whatever
            # the model dtype was.
            object.__setattr__(self, "dtype", "uint8")

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    @property
    def block_shape(self) -> tuple[int, ...]:
        if self.quantized:
            values = (self.n_layers * self.kv_dims * self.page_size
                      * self.kv_head_count * self.head_dim)  # int8: 1 B
            scales = (self.n_layers * self.kv_dims * self.page_size
                      * self.scale_lanes * 2)  # bf16: 2 B
            return (values + scales,)
        return (self.n_layers, self.kv_dims, self.page_size,
                self.kv_head_count, self.head_dim)

    def block_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.torch_dtype).element_size()
        return math.prod(self.block_shape) * itemsize

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: dict) -> "BlockLayoutSpec":
        return cls(**{f.name: data[f.name]
                      for f in dataclasses.fields(cls) if f.name in data})

    @classmethod
    def from_runner_layout(cls, layout: dict) -> "BlockLayoutSpec":
        """From `ModelRunner.kv_layout()` (either package's runner)."""
        return cls(
            n_layers=layout["n_layers"], total_kv_heads=layout["kv_heads"],
            head_dim=layout["head_dim"], page_size=layout["page_size"],
            dtype=layout["dtype"], kv_dims=layout.get("kv_dims", 2),
            kv_dtype=layout.get("kv_dtype", "model"),
            scale_lanes=layout.get("scale_lanes", 0),
        )

    def head_range(self) -> tuple[int, int]:
        return self.kv_head_start, self.kv_head_start + self.kv_head_count


def _check_bridgeable(src: BlockLayoutSpec, dst: BlockLayoutSpec) -> None:
    if src.quantized != dst.quantized:
        raise ValueError(
            "cannot bridge a packed-int8 KV layout with an unquantized "
            f"one ({src.kv_dtype!r} vs {dst.kv_dtype!r}): the per-token "
            "scale state has no unquantized counterpart")
    if (src.n_layers, src.page_size, src.head_dim, src.kv_dims) != (
            dst.n_layers, dst.page_size, dst.head_dim, dst.kv_dims):
        raise ValueError(f"incompatible layouts: {src} vs {dst}")
    if src.quantized and src.scale_lanes != dst.scale_lanes:
        raise ValueError(
            f"incompatible scale-row widths: {src.scale_lanes} vs "
            f"{dst.scale_lanes}")


def _split_packed(bundle: torch.Tensor, spec: BlockLayoutSpec
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpack a packed bundle [n, value_bytes + scale_bytes] into the
    head-shaped int8 value bytes [n, L, kv_dims, ps, kh, hd] and the opaque
    per-token scale bytes [n, scale_bytes]. Views, no copies."""
    if bundle.ndim != 2 or bundle.shape[1] != spec.block_shape[0]:
        raise ValueError(
            f"packed bundle shape {tuple(bundle.shape)} does not match "
            f"layout {spec.block_shape} (n_blocks x bytes expected)")
    nv = (spec.n_layers * spec.kv_dims * spec.page_size
          * spec.kv_head_count * spec.head_dim)
    values = bundle[:, :nv].reshape(
        bundle.shape[0], spec.n_layers, spec.kv_dims, spec.page_size,
        spec.kv_head_count, spec.head_dim)
    return values, bundle[:, nv:]


def _join_packed(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return torch.cat([values.reshape(values.shape[0], -1), scales],
                     dim=1).contiguous()


def reslice(bundle: torch.Tensor, src: BlockLayoutSpec,
            dst: BlockLayoutSpec) -> torch.Tensor:
    """Re-slice a universal block bundle from a source shard's head range
    to a destination shard's (`assemble` builds full coverage from several
    sources).

    Packed int8 bundles unpack into the value bytes, reindex the kv-head
    axis like the unquantized path and repack, bit-exact. The per-token
    scale rows are shared by the heads, so they pass through verbatim."""
    _check_bridgeable(src, dst)
    if src.quantized and src == dst:
        return bundle
    d0, d1 = dst.head_range()
    s0, s1 = src.head_range()
    if d0 < s0 or d1 > s1:
        raise ValueError(
            f"dst heads [{d0},{d1}) not covered by src [{s0},{s1})")
    if src.quantized:
        values, scales = _split_packed(bundle, src)
        return _join_packed(values[..., d0 - s0 : d1 - s0, :], scales)
    out = bundle[..., d0 - s0 : d1 - s0, :]
    if src.dtype != dst.dtype:
        out = out.to(dst.torch_dtype)
    return out.contiguous()


def assemble(shards: list[tuple[BlockLayoutSpec, torch.Tensor]],
             dst: BlockLayoutSpec) -> torch.Tensor:
    """Build `dst`'s block bundle from several source shards (e.g. prefill
    TP=4 -> decode TP=8: each decode shard assembles from the one or two
    prefill shards overlapping its head range).

    Packed int8 shards assemble head-wise over their value bytes and
    repack. Every covering shard carries the same per-token scale rows;
    shards that disagree were quantized inconsistently, and assembling
    them raises instead of mixing scales."""
    if dst.quantized:
        for spec, bundle in shards:
            if spec == dst:
                return bundle
        d0, d1 = dst.head_range()
        n = shards[0][1].shape[0]
        out = torch.empty(
            (n, dst.n_layers, dst.kv_dims, dst.page_size,
             dst.kv_head_count, dst.head_dim), dtype=torch.uint8)
        covered = torch.zeros(dst.kv_head_count, dtype=torch.bool)
        scales = None
        for spec, bundle in shards:
            _check_bridgeable(spec, dst)
            if bundle.shape[0] != n:
                raise ValueError(
                    f"shard block counts disagree: {bundle.shape[0]} "
                    f"vs {n}")
            s0, s1 = spec.head_range()
            lo, hi = max(d0, s0), min(d1, s1)
            if lo >= hi:
                continue
            values, shard_scales = _split_packed(bundle, spec)
            out[..., lo - d0 : hi - d0, :] = values[..., lo - s0 : hi - s0, :]
            covered[lo - d0 : hi - d0] = True
            if scales is None:
                scales = shard_scales
            elif not torch.equal(scales, shard_scales):
                raise ValueError(
                    "covering shards carry disagreeing per-token scale "
                    "rows; refusing to assemble a corrupt quantized "
                    "bundle")
        if not bool(covered.all()):
            raise ValueError("source shards do not cover dst head range")
        return _join_packed(out, scales)
    d0, d1 = dst.head_range()
    first = shards[0][1]
    out = torch.empty(tuple(first.shape[:-2])
                      + (dst.kv_head_count, dst.head_dim),
                      dtype=dst.torch_dtype)
    covered = torch.zeros(dst.kv_head_count, dtype=torch.bool)
    for spec, bundle in shards:
        s0, s1 = spec.head_range()
        lo, hi = max(d0, s0), min(d1, s1)
        if lo >= hi:
            continue
        out[..., lo - d0 : hi - d0, :] = bundle[..., lo - s0 : hi - s0, :]
        covered[lo - d0 : hi - d0] = True
    if not bool(covered.all()):
        raise ValueError("source shards do not cover dst head range")
    return out
