"""Paged-KV block movement: the page gathers and scatters of KV transfers.

Port of `dynamo_tpu/ops/block_copy.py`. The reference leaves these to XLA
(a jitted gather or scatter over the page axis), so here they are plain
PyTorch indexing on the pool's device, not kernels.

The universal bundle is page-major, `[n, L, 2, ps, kh, hd]`. An int8 pool
moves as PACKED blocks, byte for byte the reference's: each page's int8
value bytes, then its bf16 scale rows over `KV_SCALE_LANES` lanes, as one
uint8 row `[n, value_bytes + scale_bytes]`. The port keeps one scale per
token (`[L, 2, P, ps]`), so its gather broadcasts each scale over the 128
lanes and its scatter takes lane 0, raising if the lanes differ (as
`models.convert.kv_cache_from_numpy` does).

Every scatter writes into the pool's own tensors (`index_copy_`): the
runner's CUDA graphs captured their storage, so a pool rebound to new
tensors, as the reference's donation rebinds it, would leave every graph
reading stale pages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.transformer import KV_SCALE_LANES


def _ids(page_ids, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(page_ids, np.int64)).to(device)


def gather_kv_blocks(kv_cache: torch.Tensor, page_ids) -> torch.Tensor:
    """Pages out of a pool [L, 2, P, ps, kh, hd] into a fresh bundle
    [n, L, 2, ps, kh, hd]."""
    ids = _ids(page_ids, kv_cache.device)
    return kv_cache.index_select(2, ids).permute(2, 0, 1, 3, 4, 5).contiguous()


def scatter_kv_blocks(kv_cache: torch.Tensor, page_ids,
                      blocks: torch.Tensor) -> torch.Tensor:
    """Write a bundle [n, L, 2, ps, kh, hd] on the pool's device into pool
    pages, in place. Returns the pool (the same tensor)."""
    ids = _ids(page_ids, kv_cache.device)
    pool_major = blocks.to(dtype=kv_cache.dtype).permute(1, 2, 0, 3, 4, 5)
    kv_cache.index_copy_(2, ids, pool_major)
    return kv_cache


def gather_kv_blocks_q8(values: torch.Tensor, scales: torch.Tensor,
                        page_ids, lanes: int = KV_SCALE_LANES) -> torch.Tensor:
    """An int8 pool (values [L, 2, P, ps, kh, hd], scales bf16 [L, 2, P, ps])
    into packed uint8 blocks [n, value_bytes + scale_bytes]: the value bytes,
    then each token's scale repeated over `lanes` bf16 lanes."""
    ids = _ids(page_ids, values.device)
    v = values.index_select(2, ids).permute(2, 0, 1, 3, 4, 5)
    s = scales.index_select(2, ids).permute(2, 0, 1, 3)
    n = v.shape[0]
    v8 = v.contiguous().view(torch.uint8).reshape(n, -1)
    s8 = (s.unsqueeze(-1).expand(*s.shape, lanes).contiguous()
          .view(torch.uint8).reshape(n, -1))
    return torch.cat([v8, s8], dim=1)


def unpack_kv_blocks_q8(packed: torch.Tensor, value_shape: tuple,
                        lanes: int = KV_SCALE_LANES) -> tuple:
    """Packed uint8 blocks [n, bytes] -> (int8 values [n, L, 2, ps, kh, hd],
    bf16 scales [n, L, 2, ps]). `value_shape` is (L, 2, ps, kh, hd). Raises
    ValueError when a token's scale lanes differ or the row length is not
    this geometry's."""
    layers, kv_dims, ps, kh, hd = value_shape
    n = packed.shape[0]
    nv = layers * kv_dims * ps * kh * hd
    ns = layers * kv_dims * ps * lanes * 2
    if packed.dtype != torch.uint8 or packed.shape[1] != nv + ns:
        raise ValueError(f"packed int8 blocks of {tuple(packed.shape)} "
                         f"{packed.dtype} are not [n, {nv + ns}] uint8")
    v = packed[:, :nv].contiguous().view(torch.int8).reshape(
        n, layers, kv_dims, ps, kh, hd)
    s = packed[:, nv:].contiguous().view(torch.bfloat16).reshape(
        n, layers, kv_dims, ps, lanes)
    lane0 = s[..., 0]
    if not torch.equal(s, lane0.unsqueeze(-1).expand_as(s)):
        raise ValueError("int8 KV scale rows must repeat one value per token "
                         "across their lanes")
    return v, lane0


def scatter_kv_blocks_q8(values: torch.Tensor, scales: torch.Tensor,
                         page_ids, packed: torch.Tensor) -> tuple:
    """Write packed int8 blocks on the pool's device into the two-tensor
    pool, in place (the inverse of gather_kv_blocks_q8). Returns (values,
    scales)."""
    layers, kv_dims, _, ps, kh, hd = values.shape
    v, s = unpack_kv_blocks_q8(packed, (layers, kv_dims, ps, kh, hd))
    ids = _ids(page_ids, values.device)
    values.index_copy_(2, ids, v.permute(1, 2, 0, 3, 4, 5))
    scales.index_copy_(2, ids, s.permute(1, 2, 0, 3))
    return values, scales


def pad_bundle_pow2(page_ids: np.ndarray, blocks: np.ndarray):
    """Pad a (page_ids, blocks) pair to a power-of-two count by repeating
    the last entry (writing one block to one page twice is idempotent). The
    reference pads every host onboard so its jitted scatter compiles
    O(log n) shapes; the port's indexed writes take any count, so its
    scatters do not pad."""
    n = len(page_ids)
    m = 1 << max(0, n - 1).bit_length()
    if m == n or n == 0:
        return page_ids, blocks
    reps = m - n
    page_ids = np.concatenate([page_ids, np.repeat(page_ids[-1:], reps)])
    blocks = np.concatenate([blocks, np.repeat(blocks[-1:], reps, axis=0)])
    return page_ids, blocks


def scatter_from_host(kv_cache: torch.Tensor, page_ids,
                      blocks: torch.Tensor) -> torch.Tensor:
    """Host -> device onboard of a bundle (a CPU tensor): one H2D copy,
    then the indexed write into the pool."""
    return scatter_kv_blocks(kv_cache, page_ids, blocks.to(kv_cache.device))


def scatter_from_host_q8(values: torch.Tensor, scales: torch.Tensor,
                         page_ids, packed: torch.Tensor) -> tuple:
    """Host -> device onboard of packed int8 blocks (a CPU tensor)."""
    return scatter_kv_blocks_q8(values, scales, page_ids,
                                packed.to(values.device))
