"""Paged decode attention: the whole-pool kernel, the one-layer kernels and
the attention functions built on them.

Port of `dynamo_tpu/ops/paged_attention.py`. Three kernels of the reference
become four entry points of the hand-written CUDA source
`csrc/paged_decode_pool.cu`:

  * `paged_decode_attention_pool` (rows 1 and 2 of the kernel table):
    flash-decode partials over the paged history, reading the whole pool
    at `layer` (bf16, or int8 through `paged_decode_attention_pool_int8`
    when `kv_scales` is given). `paged_decode_attention_pool_folded` is the
    same kernel at a speculative chunk's folded width, counted apart.
  * `paged_decode_attention` (row 3): normalized flash decode over one
    layer's K and V slices, lengths including the current token (already
    written): the unified T = 1 forward's kernel.
  * `paged_decode_attention_partial` (row 4): unnormalized partials over
    one layer's slices, history lengths.

The slices are strided views of the pool (`kv_cache[layer, 0]`); the kernel
reads them in place, never a `.contiguous()` copy. Each wrapper launches
its kernel for CUDA tensors and raises on anything the kernel does not
take; it runs its plain PyTorch version (`*_ref`) only for tensors that lie
on the CPU.

The kernel splits the history over the grid (flash-decoding): `split_plan`
chooses, from host shapes only, the span of history tokens each block
takes and the row tiles of the group; with more than one split a second
kernel merges the splits' partials. The span is fixed (SPAN tokens, cut to
whole tiles and pages), so a sequence's partials are summed in one order
whatever the batch and the table width hold: a stream replayed or handed
off into another batch decodes bit-equal. `_merge_split_partials` is the plain
mirror of that split-and-merge, for the tests.

Around them, as in the reference: `_combine_current` / `_combine_chunk`
fold the current token / the speculative chunk (not yet in the pool) into
the partials; `paged_attention_decode_pool` and
`paged_attention_decode_fused` are `decode_attention_fn`s for
`forward_decode`, `paged_attention_spec_pool` and `paged_attention_spec`
`spec_attention_fn`s for `forward_spec` (the chunk folded into the GQA
group by `_fold_chunk`), and `paged_attention` is an `attention_fn` for the
unified `forward`.

The KV pool is either one bf16 tensor [L, 2, P, ps, kh, hd] or an int8
pair (values int8 [L, 2, P, ps, kh, hd], scales bf16 [L, 2, P, ps]) with
one scale per token shared by the kv heads (`models.transformer.
quantize_kv`). The reference keeps that scale broadcast over 128 lanes, a
TPU tiling artifact; the port keeps one value. Its m / l partials are
[B, kh, g] where the reference's kernels write them lane-broadcast.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from ._launch import (
    check_launch,
    count_launch,
    require,
    runs_plain,
    stream_of,
)

_KERNEL = "paged_decode_pool"
# The kernel's tiling (csrc/paged_decode_pool.cu): history tokens per ring
# stage (kTile), the most tokens one split takes (kMaxSpan), and the tokens
# a split takes: two tiles, whatever the batch and the table width. Of the
# spans that decode bit-equal in any batch, 128 costs least over table
# widths of 8-128 pages on an H100 (scripts/torch_decode_span.py; 256 is
# 1.3-1.4x slower at 16-64 pages, and a one-tile span of 64 does not
# decode bit-equal across batches).
TILE = 64
MAX_SPAN = 2048
SPAN = 128

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "paged_decode_pool_bf16": [_PTR] * 10 + [_INT] * 8 + [_LL] * 4,
    "paged_decode_pool_int8": [_PTR] * 11 + [_INT] * 8 + [_LL] * 6,
    "paged_decode_bf16": [_PTR] * 9 + [_INT] * 8 + [_LL] * 2,
    "paged_decode_partial_bf16": [_PTR] * 11 + [_INT] * 8 + [_LL] * 2,
}


def _kernel_fn(entry: str):
    """The C entry point, built on first use; ctypes caches the function
    object on the library, so its signature is declared once."""
    fn = getattr(_build.load(_KERNEL), entry)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[entry] + [ctypes.c_float, _PTR]
        fn.restype = ctypes.c_int
    return fn


class SplitPlan(NamedTuple):
    """How one launch covers (sequences x kv heads x group rows x history):
    blocks of `row_tile` query rows (`row_tiles` per kv head) over spans of
    `span` history tokens (`n_split` per sequence); `grid` is the CUDA grid
    (n_split, kh * row_tiles, batch)."""
    row_tile: int
    row_tiles: int
    span: int
    n_split: int
    grid: tuple


def split_plan(batch: int, kh: int, rows: int, max_pages: int,
               ps: int) -> SplitPlan:
    """The kernel's split plan, from host-known shapes only (never the
    lengths, so planning never waits for the card). A span is a whole
    number of 64-token tiles and of pages: the most of them that fit in
    SPAN tokens (at least one, at most MAX_SPAN tokens), set by the page
    size alone, so a sequence's splits are the same in any batch and at any
    table width; the splits cover the table's max_pages * ps tokens."""
    row_tile = 16 if rows <= 16 else 32
    row_tiles = -(-rows // row_tile)
    unit = TILE * ps // math.gcd(TILE, ps)
    if unit > MAX_SPAN:
        raise ValueError(f"page size {ps} does not tile into spans of at "
                         f"most {MAX_SPAN} tokens")
    units = -(-(max_pages * ps) // unit)
    per = max(1, min(SPAN, MAX_SPAN) // unit)
    n_split = -(-units // per)
    return SplitPlan(row_tile, row_tiles, per * unit, n_split,
                     (n_split, kh * row_tiles, batch))


def split_spans(plan: SplitPlan, length: int, ps: int,
                max_pages: int) -> list:
    """The (start, end) history positions each live split of one sequence
    reads, in split order, as the kernel computes them: the length is cut
    to the table's ceil(length / ps) owned pages, and a split starting at
    or past it reads nothing (and is not merged). Split s reads table
    entries [start // ps, ceil(end / ps))."""
    n_pages = min(-(-length // ps), max_pages) if length > 0 else 0
    length = min(length, n_pages * ps)
    spans = []
    for s in range(plan.n_split):
        start = s * plan.span
        end = min(start + plan.span, length)
        if start < end:
            spans.append((start, end))
    return spans


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _partials_ref(q, k_pages, v_pages, block_tables, lens, k_scales=None,
                  v_scales=None):
    """Gather the table's pages of one layer's K and V (dequantized by their
    per-token scales for int8), masked scores in f32, unnormalized partials
    over positions < lens. Zero-length rows give acc = 0, m = -inf, l = 0,
    as the kernel writes them."""
    b, qh, hd = q.shape
    ps, kh = k_pages.shape[1], k_pages.shape[2]
    group = qh // kh
    ctx = block_tables.shape[1] * ps
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, ctx, kh, hd).float()
    v = v_pages[tables].reshape(b, ctx, kh, hd).float()
    if k_scales is not None:
        k = k * k_scales[tables].reshape(b, ctx, 1, 1).float()
        v = v * v_scales[tables].reshape(b, ctx, 1, 1).float()
    qg = q.reshape(b, kh, group, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k) / math.sqrt(hd)
    mask = (torch.arange(ctx, device=q.device)[None, :]
            < lens.long()[:, None])
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1)  # -inf on zero-length rows
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    probs = torch.exp(scores - m_safe[..., None])
    l = probs.sum(dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", probs, v)
    return acc, m, l


def paged_decode_attention_pool_ref(
    q: torch.Tensor,  # [B, qh, hd]
    kv_pool: torch.Tensor,  # [L, 2, P, ps, kh, hd]
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens_hist: torch.Tensor,  # [B] int32 history length
    kv_scales: Optional[torch.Tensor] = None,  # [L, 2, P, ps] bf16 (int8)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the whole-pool kernel (rows 1 and 2)."""
    scales = ((kv_scales[layer, 0], kv_scales[layer, 1])
              if kv_scales is not None else ())
    return _partials_ref(q, kv_pool[layer, 0], kv_pool[layer, 1],
                         block_tables, kv_lens_hist, *scales)


def paged_decode_attention_partial_ref(
    q: torch.Tensor,  # [B, qh, hd]
    k_pages: torch.Tensor,  # [P, ps, kh, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens_hist: torch.Tensor,  # [B] int32 history length
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the one-layer partials kernel (row 4)."""
    return _partials_ref(q, k_pages, v_pages, block_tables, kv_lens_hist)


def paged_decode_attention_ref(
    q: torch.Tensor,  # [B, qh, hd]
    k_pages: torch.Tensor,  # [P, ps, kh, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] int32 INCLUDING the current token
) -> torch.Tensor:
    """Plain PyTorch version of the normalized kernel (row 3): acc / l in
    q's dtype, 0 for a zero-length row (the reference divides by 1
    there)."""
    acc, _m, l = _partials_ref(q, k_pages, v_pages, block_tables, kv_lens)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def _merge_split_partials(q, k_pages, v_pages, block_tables, lens,
                          plan: SplitPlan, k_scales=None, v_scales=None):
    """Plain mirror of the kernel's split-and-merge: `_partials_ref` over
    each split's span of the table, then the splits rescaled to a common
    max as the merge kernel does (f32). A row with no live split is
    acc = 0, m = -inf, l = 0. For the tests; nothing on the main path calls
    it."""
    ps, max_pages = k_pages.shape[1], block_tables.shape[1]
    per_page = plan.span // ps
    n_pages = torch.minimum(-(-lens.long() // ps), torch.tensor(max_pages))
    hist = torch.minimum(lens.long(), n_pages * ps).clamp_min(0)
    parts = []
    for s in range(plan.n_split):
        cols = block_tables[:, s * per_page:(s + 1) * per_page]
        span_lens = (hist - s * plan.span).clamp(0, plan.span).to(lens.dtype)
        parts.append(_partials_ref(q, k_pages, v_pages, cols, span_lens,
                                   k_scales, v_scales))
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for p_acc, p_m, p_l in parts:
        w = torch.exp(p_m - m_safe)  # 0 for an empty split
        acc = acc + w[..., None] * p_acc
        l = l + w * p_l
    return acc, m, l


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_group(name, q, kh, hd) -> int:
    require(q.shape[1] % kh == 0, name,
            f"{q.shape[1]} query rows do not split over {kh} kv heads")
    group = q.shape[1] // kh
    require(hd in (64, 128), name,
            f"the CUDA kernel supports head_dim 64 or 128, got {hd}")
    return group


def _check_common(name, q, block_tables, lens):
    require(q.dtype == torch.bfloat16, name,
            f"the CUDA kernel takes bf16 q, got {q.dtype}", TypeError)
    require(block_tables.dtype == torch.int32 and lens.dtype == torch.int32,
            name, "block_tables and lengths must be int32", TypeError)
    require(q.dim() == 3 and block_tables.dim() == 2 and lens.dim() == 1,
            name, "expected q [B, qh, hd], tables [B, max_pages], lens [B]")
    require(block_tables.shape[0] == q.shape[0] and lens.shape[0] == q.shape[0],
            name, "block_tables / lengths batch != q batch")
    require(q.is_contiguous() and block_tables.is_contiguous()
            and lens.is_contiguous(), name,
            "q, block_tables and lengths must be contiguous")


def _check_pool_inputs(name, q, kv_pool, layer, block_tables, kv_lens_hist,
                       pool_dtype):
    """Validation of the whole-pool entry points; returns (b, kh, group,
    hd, ps)."""
    _check_common(name, q, block_tables, kv_lens_hist)
    require(kv_pool.dtype == pool_dtype, name,
            f"the CUDA kernel takes a {pool_dtype} pool, got {kv_pool.dtype}",
            TypeError)
    require(kv_pool.dim() == 6, name, "expected pool [L, 2, P, ps, kh, hd]")
    b, _, hd = q.shape
    n_layers, two, _, ps, kh, pool_hd = kv_pool.shape
    require(two == 2 and pool_hd == hd, name,
            f"pool {tuple(kv_pool.shape)} does not match q {tuple(q.shape)}")
    group = _check_group(name, q, kh, hd)
    require(0 <= layer < n_layers, name,
            f"layer {layer} out of range for {n_layers} layers", IndexError)
    require(kv_pool.is_contiguous(), name, "the pool must be contiguous")
    return b, kh, group, hd, ps


def _check_slice_inputs(name, q, k_pages, v_pages, block_tables, lens):
    """Validation of the one-layer entry points: K and V [P, ps, kh, hd]
    bf16 with equal strides and contiguous (kh, hd) rows, any page and
    token strides (a layer slice of the pool). Returns (b, kh, group, hd,
    ps, page stride, token stride)."""
    _check_common(name, q, block_tables, lens)
    require(k_pages.dtype == torch.bfloat16 and v_pages.dtype == torch.bfloat16,
            name, f"the CUDA kernel takes bf16 K/V, got {k_pages.dtype} and "
            f"{v_pages.dtype}", TypeError)
    require(k_pages.dim() == 4 and k_pages.shape == v_pages.shape, name,
            f"expected K and V [P, ps, kh, hd], got {tuple(k_pages.shape)} "
            f"and {tuple(v_pages.shape)}")
    b, _, hd = q.shape
    _, ps, kh, kv_hd = k_pages.shape
    require(kv_hd == hd, name,
            f"K/V head_dim {kv_hd} does not match q {tuple(q.shape)}")
    group = _check_group(name, q, kh, hd)
    s = k_pages.stride()
    require(s == v_pages.stride() and s[3] == 1 and s[2] == hd, name,
            f"K and V need equal strides and contiguous (kh, hd) rows, got "
            f"{s} and {v_pages.stride()}")
    require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
            and s[0] % 8 == 0 and s[1] % 8 == 0, name,
            "K and V rows must start on 16-byte boundaries")
    return b, kh, group, hd, ps, s[0], s[1]


def _partials(q, kh, group, hd, n_split=1):
    """Empty f32 (acc, m, l) for `n_split` splits ([B, kh, n_split, g, hd]
    and [B, kh, n_split, g]; the outputs' shapes without the split dim)."""
    b = q.shape[0]
    lead = (b, kh, n_split) if n_split > 1 else (b, kh)
    return (torch.empty(lead + (group, hd), dtype=torch.float32,
                        device=q.device),
            torch.empty(lead + (group,), dtype=torch.float32, device=q.device),
            torch.empty(lead + (group,), dtype=torch.float32, device=q.device))


def _plan_args(q, kh, group, hd, ps, block_tables):
    """The split plan's launch arguments: the three scratch pointers (None
    with one split, where the kernel writes the outputs itself), then
    n_split and span. The scratch tensors are returned too, to live until
    the call has been queued."""
    plan = split_plan(q.shape[0], kh, group, block_tables.shape[1], ps)
    scratch = (_partials(q, kh, group, hd, plan.n_split)
               if plan.n_split > 1 else ())
    ptrs = tuple(t.data_ptr() for t in scratch) or (None, None, None)
    return scratch, ptrs, (plan.n_split, plan.span)


def _launch_pool(wrapper, q, kv_pool, layer, block_tables, kv_lens_hist,
                 kv_scales=None):
    """Launch the whole-pool kernel for `wrapper` on CUDA tensors; bf16
    pool, or int8 with `kv_scales`. The wrapper's launch count rises by one
    per call, whether the split plan makes it one CUDA launch or two (the
    split kernel and its merge)."""
    name = wrapper.__name__
    quantized = kv_scales is not None
    b, kh, group, hd, ps = _check_pool_inputs(
        name, q, kv_pool, layer, block_tables, kv_lens_hist,
        torch.int8 if quantized else torch.bfloat16)
    acc, m, l = _partials(q, kh, group, hd)
    if b == 0:
        return acc, m, l
    if quantized:
        require(kv_scales.dtype == torch.bfloat16
                and tuple(kv_scales.shape) == tuple(kv_pool.shape[:4])
                and kv_scales.is_contiguous()
                and kv_scales.data_ptr() % 4 == 0, name,
                f"kv_scales must be contiguous bf16 "
                f"{tuple(kv_pool.shape[:4])}, got {kv_scales.dtype} "
                f"{tuple(kv_scales.shape)}")
        require(ps % 2 == 0, name,
                f"the int8 kernel reads scales in token pairs: page size "
                f"{ps} must be even")
    _scratch, parts, plan = _plan_args(q, kh, group, hd, ps,
                                       block_tables)
    s = kv_pool.stride()
    head = (q.data_ptr(), kv_pool.data_ptr())
    tail = (block_tables.data_ptr(), kv_lens_hist.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), *parts, b, kh, group, hd, ps,
            block_tables.shape[1], *plan, layer * s[0], s[1], s[2], s[3])
    if quantized:
        ss = kv_scales.stride()
        err = _kernel_fn("paged_decode_pool_int8")(
            *head, kv_scales.data_ptr(), *tail, layer * ss[0], ss[1],
            1.0 / math.sqrt(hd), stream_of(q))
    else:
        err = _kernel_fn("paged_decode_pool_bf16")(
            *head, *tail, 1.0 / math.sqrt(hd), stream_of(q))
    check_launch(name, err)
    count_launch(wrapper)
    return acc, m, l


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
    if runs_plain("paged_decode_attention_pool_int8",
                  (q, kv_pool, kv_scales, block_tables, kv_lens_hist)):
        return paged_decode_attention_pool_ref(q, kv_pool, layer, block_tables,
                                               kv_lens_hist, kv_scales)
    return _launch_pool(paged_decode_attention_pool_int8, q, kv_pool, layer,
                        block_tables, kv_lens_hist, kv_scales)


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
    anything else raises). CPU tensors run the plain version. `.launches`
    (here and on every wrapper below) counts one per call that launches,
    though with more than one split the call is two CUDA launches: the
    split kernel and its merge."""
    if kv_scales is not None:
        return paged_decode_attention_pool_int8(
            q, kv_pool, kv_scales, layer, block_tables, kv_lens_hist)
    if runs_plain("paged_decode_attention_pool",
                  (q, kv_pool, block_tables, kv_lens_hist)):
        return paged_decode_attention_pool_ref(q, kv_pool, layer,
                                               block_tables, kv_lens_hist)
    return _launch_pool(paged_decode_attention_pool, q, kv_pool, layer,
                        block_tables, kv_lens_hist)


def paged_decode_attention_pool_int8_folded(
    q: torch.Tensor,  # [B, kh * T * g, hd] bf16, a folded chunk
    kv_pool: torch.Tensor,
    kv_scales: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,
    kv_lens_hist: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`paged_decode_attention_pool_int8` for a speculative chunk folded
    into the group (`_fold_chunk`); the same kernel, its launches counted
    apart."""
    if runs_plain("paged_decode_attention_pool_int8_folded",
                  (q, kv_pool, kv_scales, block_tables, kv_lens_hist)):
        return paged_decode_attention_pool_ref(q, kv_pool, layer, block_tables,
                                               kv_lens_hist, kv_scales)
    return _launch_pool(paged_decode_attention_pool_int8_folded, q, kv_pool,
                        layer, block_tables, kv_lens_hist, kv_scales)


def paged_decode_attention_pool_folded(
    q: torch.Tensor,  # [B, kh * T * g, hd] bf16, a folded chunk
    kv_pool: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,
    kv_lens_hist: torch.Tensor,
    kv_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`paged_decode_attention_pool` for a speculative chunk folded into the
    group (`_fold_chunk`): the same kernel at g' = T * g, its launches
    counted apart from single-token decode's."""
    if kv_scales is not None:
        return paged_decode_attention_pool_int8_folded(
            q, kv_pool, kv_scales, layer, block_tables, kv_lens_hist)
    if runs_plain("paged_decode_attention_pool_folded",
                  (q, kv_pool, block_tables, kv_lens_hist)):
        return paged_decode_attention_pool_ref(q, kv_pool, layer,
                                               block_tables, kv_lens_hist)
    return _launch_pool(paged_decode_attention_pool_folded, q, kv_pool, layer,
                        block_tables, kv_lens_hist)


def paged_decode_attention(
    q: torch.Tensor,  # [B, qh, hd] bf16, one query token per sequence
    k_pages: torch.Tensor,  # [P, ps, kh, hd] one layer's K (a pool slice)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] int32 INCLUDING the current token
) -> torch.Tensor:
    """Normalized flash decode over one layer's paged K/V (row 3): returns
    [B, qh, hd] in q's dtype, 0 for a zero-length row. CUDA tensors launch
    `paged_decode_bf16`; CPU tensors run the plain version."""
    name = "paged_decode_attention"
    if runs_plain(name, (q, k_pages, v_pages, block_tables, kv_lens)):
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_lens)
    b, kh, group, hd, ps, s_page, s_tok = _check_slice_inputs(
        name, q, k_pages, v_pages, block_tables, kv_lens)
    out = torch.empty_like(q)
    if b == 0:
        return out
    _scratch, parts, plan = _plan_args(q, kh, group, hd, ps,
                                       block_tables)
    check_launch(name, _kernel_fn("paged_decode_bf16")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), *parts,
        b, kh, group, hd, ps, block_tables.shape[1], *plan, s_page, s_tok,
        1.0 / math.sqrt(hd), stream_of(q)))
    count_launch(paged_decode_attention)
    return out


def paged_decode_attention_partial(
    q: torch.Tensor,  # [B, qh, hd] bf16
    k_pages: torch.Tensor,  # [P, ps, kh, hd] one layer's K (a pool slice)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens_hist: torch.Tensor,  # [B] int32 HISTORY length (current excluded)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized flash partials over one layer's paged history (row 4):
    (acc [B, kh, g, hd], m [B, kh, g], l [B, kh, g]) f32. CUDA tensors
    launch `paged_decode_partial_bf16`; CPU tensors run the plain
    version."""
    name = "paged_decode_attention_partial"
    if runs_plain(name, (q, k_pages, v_pages, block_tables, kv_lens_hist)):
        return paged_decode_attention_partial_ref(q, k_pages, v_pages,
                                                  block_tables, kv_lens_hist)
    b, kh, group, hd, ps, s_page, s_tok = _check_slice_inputs(
        name, q, k_pages, v_pages, block_tables, kv_lens_hist)
    acc, m, l = _partials(q, kh, group, hd)
    if b == 0:
        return acc, m, l
    _scratch, parts, plan = _plan_args(q, kh, group, hd, ps,
                                       block_tables)
    check_launch(name, _kernel_fn("paged_decode_partial_bf16")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), kv_lens_hist.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), *parts, b, kh, group, hd, ps,
        block_tables.shape[1], *plan, s_page, s_tok, 1.0 / math.sqrt(hd),
        stream_of(q)))
    count_launch(paged_decode_attention_partial)
    return acc, m, l


# Kernel launches since the last reset (the plain CPU versions never count):
# one per wrapper call that launches, whether the split plan makes it one
# CUDA launch or two (the split kernel and its merge).
paged_decode_attention_pool.launches = 0
paged_decode_attention_pool_int8.launches = 0
paged_decode_attention_pool_folded.launches = 0
paged_decode_attention_pool_int8_folded.launches = 0
paged_decode_attention.launches = 0
paged_decode_attention_partial.launches = 0


# ---------------------------------------------------------------------------
# Attention functions for the forwards
# ---------------------------------------------------------------------------


def _bf16_pool(kv_cache, name: str) -> torch.Tensor:
    """The one-layer kernels read a bf16 pool; an int8 pair is refused (the
    reference's drop-ins index a single array too)."""
    if isinstance(kv_cache, tuple):
        raise TypeError(f"{name} takes a bf16 pool, not an int8 "
                        "(values, scales) pair")
    return kv_cache


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


def paged_attention_decode_fused(
    q: torch.Tensor,  # [B, 1, qh, hd]
    kv_cache: torch.Tensor,  # [L, 2, P, ps, kh, hd] bf16
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] int32 INCLUDING the current token
    k_cur: torch.Tensor,  # [B, 1, kh, hd] current token's K (not yet cached)
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Deferred-write decode attention through the one-layer partials kernel
    (row 4) over `kv_cache[layer, 0/1]`, combined with the in-register
    current token. Drop-in for `paged_attention_decode_xla`."""
    kv = _bf16_pool(kv_cache, "paged_attention_decode_fused")
    acc, m, l = paged_decode_attention_partial(
        q[:, 0], kv[layer, 0], kv[layer, 1], block_tables,
        (kv_lens - 1).clamp_min(0))
    return _combine_current(q, acc, m, l, k_cur, v_cur)


def _fold_chunk(q: torch.Tensor, kh: int) -> torch.Tensor:
    """[B, T, qh, hd] -> [B, kh * (T * g), hd]: fold the chunk dim into the
    GQA group so one kernel launch scores all T positions against the
    history they share (positions < kv_len - 1); the causal in-chunk part
    is combined outside (`_combine_chunk`)."""
    b, t, qh, hd = q.shape
    group = qh // kh
    return (q.reshape(b, t, kh, group, hd).permute(0, 2, 1, 3, 4)
            .reshape(b, kh * t * group, hd))


def _unfold_chunk(acc, m, l, t: int):
    """Undo `_fold_chunk` on kernel outputs: acc [B, kh, T*g, hd] ->
    [B, T, kh, g, hd]; m / l [B, kh, T*g] -> [B, T, kh, g]."""
    b, kh, tg, hd = acc.shape
    g = tg // t
    acc = acc.reshape(b, kh, t, g, hd).permute(0, 2, 1, 3, 4)
    m = m.reshape(b, kh, t, g).permute(0, 2, 1, 3)
    l = l.reshape(b, kh, t, g).permute(0, 2, 1, 3)
    return acc, m, l


def _combine_chunk(q, acc, m, l, k_cur, v_cur):
    """Fold the in-register chunk tokens into unnormalized flash partials
    with CAUSAL in-chunk masking (query i sees chunk tokens j <= i), the
    T-token generalization of `_combine_current`.

    q [B, T, qh, hd]; acc [B, T, kh, g, hd] f32; m / l [B, T, kh, g];
    k_cur / v_cur [B, T, kh, hd]. Returns [B, T, qh, hd] in q's dtype."""
    b, t, qh, hd = q.shape
    kh = k_cur.shape[2]
    g = qh // kh
    qg = q.reshape(b, t, kh, g, hd).float()
    s = torch.einsum("btkgh,bskh->btkgs", qg, k_cur.float()) / math.sqrt(hd)
    pos = torch.arange(t, device=q.device)
    causal = pos[None, :] <= pos[:, None]  # [Tq, Tk]: key j <= query i
    s = s.masked_fill(~causal[None, :, None, None, :], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))  # finite: the diagonal is kept
    alpha = torch.exp(m - m_new)  # 0 when the history is empty
    probs = torch.exp(s - m_new[..., None])  # masked entries -> exact 0
    out = (acc * alpha[..., None]
           + torch.einsum("btkgs,bskh->btkgh", probs, v_cur.float()))
    denom = l * alpha + probs.sum(dim=-1)
    return (out / denom[..., None]).reshape(b, t, qh, hd).to(q.dtype)


def paged_attention_spec(
    q: torch.Tensor,  # [B, T, qh, hd] chunk queries (token 0 = committed)
    kv_cache: torch.Tensor,  # [L, 2, P, ps, kh, hd] bf16
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] committed length INCLUDING chunk token 0
    k_cur: torch.Tensor,  # [B, T, kh, hd] chunk K (not yet cached)
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Speculative verification attention through the one-layer partials
    kernel (row 4): the T chunk queries folded into the group stream the
    layer's paged history once, then the causal in-chunk combine. Drop-in
    for `models.transformer.paged_attention_spec_xla`."""
    kv = _bf16_pool(kv_cache, "paged_attention_spec")
    t, kh = q.shape[1], k_cur.shape[2]
    acc, m, l = paged_decode_attention_partial(
        _fold_chunk(q, kh), kv[layer, 0], kv[layer, 1], block_tables,
        (kv_lens - 1).clamp_min(0))
    return _combine_chunk(q, *_unfold_chunk(acc, m, l, t), k_cur, v_cur)


def paged_attention_spec_pool(
    q: torch.Tensor,  # [B, T, qh, hd]
    kv_cache,  # [L, 2, P, ps, kh, hd] or the int8 (values, scales) pair
    layer: int,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,  # [B] committed length INCLUDING chunk token 0
    k_cur: torch.Tensor,  # [B, T, kh, hd]
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Speculative verification through the whole-pool kernel, the
    production path: one launch streams each owned page once for all T
    positions (`paged_decode_attention_pool_folded`, bf16 or int8). Drop-in
    for `paged_attention_spec_xla` in `forward_spec`."""
    values, scales = kv_cache if isinstance(kv_cache, tuple) else (kv_cache,
                                                                   None)
    t, kh = q.shape[1], k_cur.shape[2]
    acc, m, l = paged_decode_attention_pool_folded(
        _fold_chunk(q, kh), values, layer, block_tables,
        (kv_lens - 1).clamp_min(0), kv_scales=scales)
    return _combine_chunk(q, *_unfold_chunk(acc, m, l, t), k_cur, v_cur)


def paged_attention(
    q: torch.Tensor,  # [B, T, qh, hd]
    kv_cache,  # [L, 2, P, ps, kh, hd] or the int8 (values, scales) pair
    layer: int,
    block_tables: torch.Tensor,
    positions: torch.Tensor,  # [B, T]
    kv_lens: torch.Tensor,  # [B] kv tokens visible (incl. this chunk)
) -> torch.Tensor:
    """`attention_fn` for the unified `forward`, which has written this
    layer's K/V before it attends: a bf16 decode (T == 1) runs the
    normalized kernel (row 3) over the layer's slices; prefill chunks and
    int8 pools take the plain `paged_attention_xla`, as in the
    reference."""
    if q.shape[1] != 1 or isinstance(kv_cache, tuple):
        from ..models.transformer import paged_attention_xla

        return paged_attention_xla(q, kv_cache, layer, block_tables,
                                   positions, kv_lens)
    out = paged_decode_attention(q[:, 0], kv_cache[layer, 0],
                                 kv_cache[layer, 1], block_tables, kv_lens)
    return out[:, None]
