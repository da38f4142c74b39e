"""Paged decode attention over the whole KV pool.

Port of the production decode path of `dynamo_tpu/ops/paged_attention.py`:
`paged_decode_attention_pool` (flash-decode partials over the paged
history, reading the whole pool), `_combine_current` (folds the current
token, which is not yet in the pool, into the partials) and
`paged_attention_decode_pool` (the two together, a drop-in
`decode_attention_fn` for `forward_decode`).

`paged_decode_attention_pool` launches the hand-written CUDA kernel
`csrc/paged_decode_pool.cu` for CUDA tensors and raises on anything the
kernel does not take; it runs the plain PyTorch version
`paged_decode_attention_pool_ref` only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_KERNEL = "paged_decode_pool"
_MAX_GROUP_DIM = 1024  # largest g * hd the kernel's accumulators cover


def _kernel_fn():
    """The C entry point, built on first use; ctypes caches the function
    object on the library, so its signature is declared once."""
    fn = _build.load(_KERNEL).paged_decode_pool_bf16
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: gather the table's pages, masked
    scores in f32, unnormalized partials. Zero-history rows give acc = 0,
    m = -inf, l = 0, as the kernel writes them."""
    b, qh, hd = q.shape
    ps, kh = kv_pool.shape[3], kv_pool.shape[4]
    group = qh // kh
    ctx = block_tables.shape[1] * ps
    tables = block_tables.long()
    k = kv_pool[layer, 0][tables].reshape(b, ctx, kh, hd).float()
    v = kv_pool[layer, 1][tables].reshape(b, ctx, kh, hd).float()
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


def paged_decode_attention_pool(
    q: torch.Tensor,  # [B, qh, hd] bf16
    kv_pool: torch.Tensor,  # [L, 2, P, ps, kh, hd] bf16, the whole cache
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens_hist: torch.Tensor,  # [B] int32 history length (current excluded)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-decode partials over the paged history. Returns
    (acc [B, kh, g, hd], m [B, kh, g], l [B, kh, g]), all f32 and
    unnormalized, for the deferred current-token combine.

    CUDA tensors launch the kernel on the current stream (bf16 only;
    anything else raises). CPU tensors run the plain version."""
    tensors = (q, kv_pool, block_tables, kv_lens_hist)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_pool_ref(q, kv_pool, layer,
                                               block_tables, kv_lens_hist)
    if not all(t.device == q.device and t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_pool: all inputs must lie "
                         f"on one CUDA device, got {[str(t.device) for t in tensors]}")
    if q.dtype != torch.bfloat16 or kv_pool.dtype != torch.bfloat16:
        raise TypeError("the CUDA kernel takes bf16 q and pool, got "
                        f"{q.dtype} and {kv_pool.dtype}")
    if block_tables.dtype != torch.int32 or kv_lens_hist.dtype != torch.int32:
        raise TypeError("block_tables and kv_lens_hist must be int32")
    if q.dim() != 3 or kv_pool.dim() != 6 or block_tables.dim() != 2 \
            or kv_lens_hist.dim() != 1:
        raise ValueError("expected q [B, qh, hd], pool [L, 2, P, ps, kh, hd], "
                         "tables [B, max_pages], lens [B]")
    b, qh, hd = q.shape
    n_layers, two, _, ps, kh, pool_hd = kv_pool.shape
    if two != 2 or pool_hd != hd or qh % kh:
        raise ValueError(f"pool {tuple(kv_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if block_tables.shape[0] != b or kv_lens_hist.shape[0] != b:
        raise ValueError("block_tables / kv_lens_hist batch != q batch")
    if hd not in (64, 128):
        raise ValueError(f"the CUDA kernel supports head_dim 64 or 128, got {hd}")
    group = qh // kh
    if group * hd > _MAX_GROUP_DIM:
        raise ValueError(f"GQA group {group} x head_dim {hd} exceeds the "
                         f"kernel's {_MAX_GROUP_DIM} accumulators")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range for {n_layers} layers")
    if not (q.is_contiguous() and kv_pool.is_contiguous()
            and block_tables.is_contiguous() and kv_lens_hist.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous inputs")
    acc = torch.empty((b, kh, group, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, kh, group), dtype=torch.float32, device=q.device)
    l = torch.empty((b, kh, group), dtype=torch.float32, device=q.device)
    if b == 0:
        return acc, m, l
    fn = _kernel_fn()
    s = kv_pool.stride()
    err = fn(q.data_ptr(), kv_pool.data_ptr(), block_tables.data_ptr(),
             kv_lens_hist.data_ptr(), acc.data_ptr(), m.data_ptr(),
             l.data_ptr(), b, kh, group, hd, ps, block_tables.shape[1],
             layer * s[0], s[1], s[2], s[3], 1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_pool kernel launch failed: "
                           f"cudaError {err}")
    paged_decode_attention_pool.launches += 1
    return acc, m, l


# Kernel launches since the last reset (the plain CPU version never counts).
paged_decode_attention_pool.launches = 0


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
    kv_cache: torch.Tensor,  # [L, 2, P, ps, kh, hd]
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] int32 INCLUDING the current token
    k_cur: torch.Tensor,  # [B, 1, kh, hd]
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Deferred-write decode attention through the whole-pool kernel: history
    partials from the pool, the current token combined in registers. Drop-in
    for `models.transformer.paged_attention_decode_xla`."""
    acc, m, l = paged_decode_attention_pool(
        q[:, 0], kv_cache, layer, block_tables, (kv_lens - 1).clamp_min(0))
    return _combine_current(q, acc, m, l, k_cur, v_cur)
