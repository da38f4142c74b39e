"""Paged decode attention over the whole KV pool.

Port of the production decode path of `dynamo_tpu/ops/paged_attention.py`:
`paged_decode_attention_pool` (flash-decode partials over the paged
history, reading the whole pool), `_combine_current` (folds the current
token, which is not yet in the pool, into the partials) and
`paged_attention_decode_pool` (the two together, a drop-in
`decode_attention_fn` for `forward_decode`).

The KV pool is either one bf16 tensor [L, 2, P, ps, kh, hd] or an int8
pair (values int8 [L, 2, P, ps, kh, hd], scales bf16 [L, 2, P, ps]) with
one scale per token shared by the kv heads (`models.transformer.
quantize_kv`). The reference keeps that scale broadcast over 128 lanes, a
TPU tiling artifact; the port keeps one value.

`paged_decode_attention_pool` launches the hand-written CUDA kernel
`csrc/paged_decode_pool.cu` for CUDA tensors (entry point
`paged_decode_pool_bf16`, or `paged_decode_pool_int8` through
`paged_decode_attention_pool_int8` when `kv_scales` is given) and raises on
anything the kernel does not take; it runs the plain PyTorch version
`paged_decode_attention_pool_ref` only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from ._launch import check_launch, require, runs_plain, stream_of

_KERNEL = "paged_decode_pool"
_MAX_GROUP_DIM = 1024  # largest g * hd the kernel's accumulators cover


def _kernel_fn(quantized: bool = False):
    """The C entry point, built on first use; ctypes caches the function
    object on the library, so its signature is declared once."""
    lib = _build.load(_KERNEL)
    if quantized:
        fn = lib.paged_decode_pool_int8
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        return fn
    fn = lib.paged_decode_pool_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_pool_ref(
    q: torch.Tensor,  # [B, qh, hd]
    kv_pool: torch.Tensor,  # [L, 2, P, ps, kh, hd]
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens_hist: torch.Tensor,  # [B] int32 history length
    kv_scales: Optional[torch.Tensor] = None,  # [L, 2, P, ps] bf16 (int8)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: gather the table's pages
    (dequantized by their per-token scales for an int8 pool), masked
    scores in f32, unnormalized partials. Zero-history rows give acc = 0,
    m = -inf, l = 0, as the kernel writes them."""
    b, qh, hd = q.shape
    ps, kh = kv_pool.shape[3], kv_pool.shape[4]
    group = qh // kh
    ctx = block_tables.shape[1] * ps
    tables = block_tables.long()
    k = kv_pool[layer, 0][tables].reshape(b, ctx, kh, hd).float()
    v = kv_pool[layer, 1][tables].reshape(b, ctx, kh, hd).float()
    if kv_scales is not None:
        k = k * kv_scales[layer, 0][tables].reshape(b, ctx, 1, 1).float()
        v = v * kv_scales[layer, 1][tables].reshape(b, ctx, 1, 1).float()
    qg = q.reshape(b, kh, group, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k) / math.sqrt(hd)
    mask = (torch.arange(ctx, device=q.device)[None, :]
            < kv_lens_hist.long()[:, None])
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1)  # -inf on zero-history rows
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    probs = torch.exp(scores - m_safe[..., None])
    l = probs.sum(dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", probs, v)
    return acc, m, l


def _check_pool_inputs(name, q, kv_pool, layer, block_tables, kv_lens_hist,
                       pool_dtype):
    """Shared validation of both entry points; returns (b, kh, group, hd,
    ps)."""
    require(q.dtype == torch.bfloat16 and kv_pool.dtype == pool_dtype, name,
            f"the CUDA kernel takes bf16 q and a {pool_dtype} pool, got "
            f"{q.dtype} and {kv_pool.dtype}", TypeError)
    require(block_tables.dtype == torch.int32
            and kv_lens_hist.dtype == torch.int32, name,
            "block_tables and kv_lens_hist must be int32", TypeError)
    require(q.dim() == 3 and kv_pool.dim() == 6 and block_tables.dim() == 2
            and kv_lens_hist.dim() == 1, name,
            "expected q [B, qh, hd], pool [L, 2, P, ps, kh, hd], tables "
            "[B, max_pages], lens [B]")
    b, qh, hd = q.shape
    n_layers, two, _, ps, kh, pool_hd = kv_pool.shape
    require(two == 2 and pool_hd == hd and qh % kh == 0, name,
            f"pool {tuple(kv_pool.shape)} does not match q {tuple(q.shape)}")
    require(block_tables.shape[0] == b and kv_lens_hist.shape[0] == b, name,
            "block_tables / kv_lens_hist batch != q batch")
    require(hd in (64, 128), name,
            f"the CUDA kernel supports head_dim 64 or 128, got {hd}")
    group = qh // kh
    require(group * hd <= _MAX_GROUP_DIM, name,
            f"GQA group {group} x head_dim {hd} exceeds the kernel's "
            f"{_MAX_GROUP_DIM} accumulators")
    require(0 <= layer < n_layers, name,
            f"layer {layer} out of range for {n_layers} layers", IndexError)
    require(q.is_contiguous() and kv_pool.is_contiguous()
            and block_tables.is_contiguous() and kv_lens_hist.is_contiguous(),
            name, "the CUDA kernel takes contiguous inputs")
    return b, kh, group, hd, ps


def _partials(q, kh, group, hd):
    b = q.shape[0]
    return (torch.empty((b, kh, group, hd), dtype=torch.float32,
                        device=q.device),
            torch.empty((b, kh, group), dtype=torch.float32, device=q.device),
            torch.empty((b, kh, group), dtype=torch.float32, device=q.device))


def paged_decode_attention_pool_int8(
    q: torch.Tensor,  # [B, qh, hd] bf16
    kv_pool: torch.Tensor,  # [L, 2, P, ps, kh, hd] int8 codes
    kv_scales: torch.Tensor,  # [L, 2, P, ps] bf16 per-token scales
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens_hist: torch.Tensor,  # [B] int32 history length
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-decode partials over an int8 pool (the reference kernel's
    `quantized=True` branch): CUDA tensors launch `paged_decode_pool_int8`,
    CPU tensors run the plain version."""
    name = "paged_decode_attention_pool_int8"
    tensors = (q, kv_pool, kv_scales, block_tables, kv_lens_hist)
    if runs_plain(name, tensors):
        return paged_decode_attention_pool_ref(q, kv_pool, layer, block_tables,
                                               kv_lens_hist, kv_scales)
    b, kh, group, hd, ps = _check_pool_inputs(
        name, q, kv_pool, layer, block_tables, kv_lens_hist, torch.int8)
    require(kv_scales.dtype == torch.bfloat16
            and tuple(kv_scales.shape) == tuple(kv_pool.shape[:4])
            and kv_scales.is_contiguous(), name,
            f"kv_scales must be contiguous bf16 {tuple(kv_pool.shape[:4])}, "
            f"got {kv_scales.dtype} {tuple(kv_scales.shape)}")
    acc, m, l = _partials(q, kh, group, hd)
    if b == 0:
        return acc, m, l
    s, ss = kv_pool.stride(), kv_scales.stride()
    check_launch(name, _kernel_fn(quantized=True)(
        q.data_ptr(), kv_pool.data_ptr(), kv_scales.data_ptr(),
        block_tables.data_ptr(), kv_lens_hist.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, kh, group, hd, ps,
        block_tables.shape[1], layer * s[0], s[1], s[2], s[3],
        layer * ss[0], ss[1], 1.0 / math.sqrt(hd), stream_of(q)))
    paged_decode_attention_pool_int8.launches += 1
    return acc, m, l


def paged_decode_attention_pool(
    q: torch.Tensor,  # [B, qh, hd] bf16
    kv_pool: torch.Tensor,  # [L, 2, P, ps, kh, hd] bf16 (or int8), the cache
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens_hist: torch.Tensor,  # [B] int32 history length (current excluded)
    kv_scales: Optional[torch.Tensor] = None,  # [L, 2, P, ps] for int8
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-decode partials over the paged history. Returns
    (acc [B, kh, g, hd], m [B, kh, g], l [B, kh, g]), all f32 and
    unnormalized, for the deferred current-token combine. With `kv_scales`
    the pool is int8 (`paged_decode_attention_pool_int8`).

    CUDA tensors launch the kernel on the current stream (bf16 only;
    anything else raises). CPU tensors run the plain version."""
    if kv_scales is not None:
        return paged_decode_attention_pool_int8(
            q, kv_pool, kv_scales, layer, block_tables, kv_lens_hist)
    name = "paged_decode_attention_pool"
    tensors = (q, kv_pool, block_tables, kv_lens_hist)
    if runs_plain(name, tensors):
        return paged_decode_attention_pool_ref(q, kv_pool, layer,
                                               block_tables, kv_lens_hist)
    b, kh, group, hd, ps = _check_pool_inputs(
        name, q, kv_pool, layer, block_tables, kv_lens_hist, torch.bfloat16)
    acc, m, l = _partials(q, kh, group, hd)
    if b == 0:
        return acc, m, l
    s = kv_pool.stride()
    check_launch(name, _kernel_fn()(
        q.data_ptr(), kv_pool.data_ptr(), block_tables.data_ptr(),
        kv_lens_hist.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, kh, group, hd, ps, block_tables.shape[1], layer * s[0], s[1],
        s[2], s[3], 1.0 / math.sqrt(hd), stream_of(q)))
    paged_decode_attention_pool.launches += 1
    return acc, m, l


# Kernel launches since the last reset (the plain CPU version never counts).
paged_decode_attention_pool.launches = 0
paged_decode_attention_pool_int8.launches = 0


def _combine_current(q, acc, m, l, k_cur, v_cur):
    """Fold the current token (K/V still in registers, not in the pool) into
    unnormalized flash partials; alpha = exp(-inf) = 0 when the history is
    empty."""
    b, _, qh, hd = q.shape
    kh = k_cur.shape[2]
    group = qh // kh
    qg = q[:, 0].reshape(b, kh, group, hd).float()
    s_cur = torch.einsum("bkgh,bkh->bkg", qg, k_cur[:, 0].float()) / math.sqrt(hd)
    m_new = torch.maximum(m, s_cur)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(s_cur - m_new)
    out = (acc * alpha[..., None]
           + beta[..., None] * v_cur[:, 0].float()[:, :, None, :])
    out = out / (l * alpha + beta)[..., None]
    return out.reshape(b, 1, qh, hd).to(q.dtype)


def paged_attention_decode_pool(
    q: torch.Tensor,  # [B, 1, qh, hd]
    kv_cache,  # [L, 2, P, ps, kh, hd] or the int8 (values, scales) pair
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] int32 INCLUDING the current token
    k_cur: torch.Tensor,  # [B, 1, kh, hd]
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Deferred-write decode attention through the whole-pool kernel: history
    partials from the pool, the current token combined in registers. Drop-in
    for `models.transformer.paged_attention_decode_xla`. An int8 pair takes
    the int8 kernel; unlike the reference, no head_dim falls back to a plain
    path (the runner refuses int8 KV unless head_dim is 128)."""
    values, scales = kv_cache if isinstance(kv_cache, tuple) else (kv_cache,
                                                                   None)
    acc, m, l = paged_decode_attention_pool(
        q[:, 0], values, layer, block_tables, (kv_lens - 1).clamp_min(0),
        kv_scales=scales)
    return _combine_current(q, acc, m, l, k_cur, v_cur)
