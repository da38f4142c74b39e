"""Dense GQA decoder transformer over a paged KV pool, in PyTorch.

Port of the dense branch of `dynamo_tpu/models/transformer.py`. The weights
live in a `Transformer` module in the JAX package's layouts (`wq [h, qh, hd]`,
`wk/wv [h, kh, hd]`, `wo [qh, hd, h]`, `w_gate/w_up [h, m]`, `w_down [m, h]`,
`embed [V, h]`, `lm_head [h, V]`), so every projection is
`x @ w.reshape(fan_in, -1)` with no transposes and the JAX package's params
carry over leaf for leaf (`models/convert.py`).

The paged KV pool is one tensor [layers, 2, pages, page_size, kv_heads, hd];
page 0 is a scratch page that block tables point unused slots at. Unlike the
JAX package, whose functions return a new cache, every function here that
writes KV (`write_kv_pages`, `write_kv_stack`, `forward`, `forward_decode`)
updates the pool IN PLACE.

Qwen3-style `qk_norm` is kept, so qwen3 configs run too. MoE, MLA, gpt-oss,
LoRA, multimodal splicing and quantized weights are not ported yet and
raise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .config import ModelConfig

AttentionFn = Callable[..., torch.Tensor]


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def check_supported(config: ModelConfig) -> None:
    """Raise for model families this port does not cover yet."""
    missing = []
    if config.is_mla:
        missing.append("MLA attention")
    if config.n_experts:
        missing.append("MoE")
    if config.is_gptoss:
        missing.append("gpt-oss sinks/sliding window")
    if config.image_token_id >= 0:
        missing.append("multimodal embedding splice")
    if missing:
        raise NotImplementedError(
            f"{config.name}: {', '.join(missing)} not ported yet")


class Transformer(nn.Module):
    """The weights of a dense GQA decoder, in the JAX package's layouts.

    `tree` has the JAX params' structure: {"embed", "final_norm",
    ["lm_head"], "layers": [{"attn_norm", "wq", "wk", "wv", "wo",
    "mlp_norm", "w_gate", "w_up", "w_down", ["q_norm", "k_norm"]}, ...]}
    with tensors as leaves. Inference only: nothing requires grad."""

    def __init__(self, config: ModelConfig, tree: dict) -> None:
        super().__init__()
        check_supported(config)
        self.config = config

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t, requires_grad=False)

        self.embed = param(tree["embed"])
        self.final_norm = param(tree["final_norm"])
        self.lm_head = (None if config.tie_embeddings
                        else param(tree["lm_head"]))
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: param(v) for k, v in layer.items()})
            for layer in tree["layers"])
        if len(self.layers) != config.n_layers:
            raise ValueError(f"{len(self.layers)} layers for a "
                             f"{config.n_layers}-layer config")

    @property
    def head(self) -> torch.Tensor:
        """[h, V] output projection (the embedding, transposed, when tied)."""
        return self.embed.t() if self.lm_head is None else self.lm_head


def init_params(config: ModelConfig, *, device: DeviceLike = "cuda",
                seed: int = 0) -> Transformer:
    """Random weights at `init_params`' scales (normal / sqrt(fan_in), norms
    at 1), drawn on `device` from a `torch.Generator` seeded with `seed`.
    The draws differ from the JAX package's for the same seed."""
    check_supported(config)
    dev = resolve_device(device)
    dtype = torch_dtype(config.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, hd = config.hidden, config.head_dim
    qh, kh, m = config.n_q_heads, config.n_kv_heads, config.mlp_hidden

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    def layer():
        p = {
            "attn_norm": ones(h),
            "wq": dense((h, qh, hd), h),
            "wk": dense((h, kh, hd), h),
            "wv": dense((h, kh, hd), h),
            "wo": dense((qh, hd, h), qh * hd),
            "mlp_norm": ones(h),
            "w_gate": dense((h, m), h),
            "w_up": dense((h, m), h),
            "w_down": dense((m, h), m),
        }
        if config.qk_norm:
            p["q_norm"] = ones(hd)
            p["k_norm"] = ones(hd)
        return p

    tree = {
        "embed": dense((config.vocab_size, h), h),
        "final_norm": ones(h),
        "layers": [layer() for _ in range(config.n_layers)],
    }
    if not config.tie_embeddings:
        tree["lm_head"] = dense((h, config.vocab_size), h)
    return Transformer(config, tree)


def make_kv_cache(config: ModelConfig, num_pages: int, page_size: int,
                  dtype: Optional[str] = None, *,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """Zeroed pool [layers, 2, pages, page_size, kv_heads, head_dim]. Page 0
    is the reserved scratch page."""
    check_supported(config)
    return torch.zeros(
        (config.n_layers, 2, num_pages, page_size, config.n_kv_heads,
         config.head_dim),
        dtype=torch_dtype(dtype or config.dtype),
        device=resolve_device(device))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [..., T, 1, hd/2] f32 for `positions` [..., T]. A forward
    pass computes them once and reuses them for q and k of every layer."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half)
    angles = positions[..., None].float() * freqs  # [..., T, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split form. x: [..., T, H, hd]; positions:
    [..., T]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _mm(x: torch.Tensor, w, k: int = 1) -> torch.Tensor:
    """Contract the last `k` dims of x with the first `k` dims of w (the JAX
    layouts make every projection a plain matmul)."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized weights (W8A16 / W4A16) are not ported yet")
    fan_in = math.prod(w.shape[:k])
    out = x.reshape(*x.shape[:-k], fan_in) @ w.reshape(fan_in, -1)
    return out.reshape(*x.shape[:-k], *w.shape[k:])


def _swiglu(x: torch.Tensor, p) -> torch.Tensor:
    gate = _mm(x, p["w_gate"])
    up = _mm(x, p["w_up"])
    return _mm(F.silu(gate) * up, p["w_down"])


def _qkv(h: torch.Tensor, lp, config: ModelConfig, cos: torch.Tensor,
         sin: torch.Tensor):
    q = _mm(h, lp["wq"])
    k = _mm(h, lp["wk"])
    v = _mm(h, lp["wv"])
    if config.qk_norm:
        q = rms_norm(q, lp["q_norm"], config.rms_eps)
        k = rms_norm(k, lp["k_norm"], config.rms_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


# ---------------------------------------------------------------------------
# Paged KV write + attention (plain PyTorch; the decode kernel is in ops/)
# ---------------------------------------------------------------------------


def _page_slots(kv_cache, block_tables, positions, valid):
    """Flat (physical page, in-page offset) per token; invalid (padding)
    tokens go to the scratch page 0."""
    page_size = kv_cache.shape[3]
    page_of = (positions // page_size).clamp(0, block_tables.shape[1] - 1)
    page_idx = torch.gather(block_tables.long(), 1, page_of.long())
    page_idx = torch.where(valid, page_idx, torch.zeros_like(page_idx))
    return page_idx.reshape(-1), (positions % page_size).reshape(-1).long()


def write_kv_pages(
    kv_cache: torch.Tensor,  # [L, 2, P, ps, kh, hd], updated IN PLACE
    layer: int,
    k: torch.Tensor,  # [B, T, kh, hd]
    v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    positions: torch.Tensor,  # [B, T] absolute positions
    valid: torch.Tensor,  # [B, T] bool
) -> torch.Tensor:
    """Scatter one layer's K/V into the pool in place; returns the pool."""
    pages, offs = _page_slots(kv_cache, block_tables, positions, valid)
    n = pages.shape[0]
    kv_cache[layer, 0, pages, offs] = k.reshape(n, *k.shape[2:]).to(kv_cache.dtype)
    kv_cache[layer, 1, pages, offs] = v.reshape(n, *v.shape[2:]).to(kv_cache.dtype)
    return kv_cache


def write_kv_stack(
    kv_cache: torch.Tensor,  # [L, 2, P, ps, kh, hd], updated IN PLACE
    k_stack: torch.Tensor,  # [L, B, T, kh, hd]
    v_stack: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, T]
    valid: torch.Tensor,  # [B, T]
) -> torch.Tensor:
    """Scatter every layer's K/V chunk into the pool in one shot (the
    deferred decode write-back), in place; returns the pool."""
    pages, offs = _page_slots(kv_cache, block_tables, positions, valid)
    n_layers, n = k_stack.shape[0], pages.shape[0]
    kv_cache[:, 0, pages, offs] = k_stack.reshape(
        n_layers, n, *k_stack.shape[3:]).to(kv_cache.dtype)
    kv_cache[:, 1, pages, offs] = v_stack.reshape(
        n_layers, n, *v_stack.shape[3:]).to(kv_cache.dtype)
    return kv_cache


def _gather_pages(kv_cache, layer, block_tables, kv: int):
    b, max_pages = block_tables.shape
    ps, kh, hd = kv_cache.shape[3:]
    pages = kv_cache[layer, kv][block_tables.long()]  # [B, mp, ps, kh, hd]
    return pages.reshape(b, max_pages * ps, kh, hd).float()


def paged_attention_xla(
    q: torch.Tensor,  # [B, T, qh, hd]
    kv_cache: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, T] absolute query positions
    kv_lens: torch.Tensor,  # [B] kv tokens visible (incl. this chunk)
) -> torch.Tensor:
    """Plain paged attention (the prefill path): gather the sequence's
    pages, masked softmax in f32."""
    b, t, qh, hd = q.shape
    kh = kv_cache.shape[4]
    k = _gather_pages(kv_cache, layer, block_tables, 0)
    v = _gather_pages(kv_cache, layer, block_tables, 1)
    ctx = k.shape[1]
    qg = q.reshape(b, t, kh, qh // kh, hd).float()
    scores = torch.einsum("btkgh,bskh->btkgs", qg, k) / math.sqrt(hd)
    kv_pos = torch.arange(ctx, device=q.device)
    # causal: kv position must be < kv_len and <= query position
    mask = ((kv_pos[None, None, :] <= positions[..., None])
            & (kv_pos[None, None, :] < kv_lens.long()[:, None, None]))
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskh->btkgh", probs, v)
    return out.reshape(b, t, qh, hd).to(q.dtype)


def paged_attention_decode_xla(
    q: torch.Tensor,  # [B, 1, qh, hd]
    kv_cache: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B] kv length INCLUDING the current token
    k_cur: torch.Tensor,  # [B, 1, kh, hd] current token's K (not yet cached)
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Plain decode attention over the cached history plus the in-register
    current token (the pool is written once per step, after all layers)."""
    b, _, qh, hd = q.shape
    kh = kv_cache.shape[4]
    k = _gather_pages(kv_cache, layer, block_tables, 0)
    v = _gather_pages(kv_cache, layer, block_tables, 1)
    ctx = k.shape[1]
    qg = q.reshape(b, kh, qh // kh, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k) / math.sqrt(hd)
    # History: positions 0 .. kv_len-2 (the current token is separate).
    mask = (torch.arange(ctx, device=q.device)[None, :]
            < (kv_lens.long()[:, None] - 1))
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    cur = torch.einsum("bkgh,bkh->bkg", qg, k_cur[:, 0].float()) / math.sqrt(hd)
    probs = torch.softmax(torch.cat([scores, cur[..., None]], dim=-1), dim=-1)
    out = (torch.einsum("bkgs,bskh->bkgh", probs[..., :-1], v)
           + probs[..., -1][..., None] * v_cur[:, 0].float()[:, :, None, :])
    return out.reshape(b, 1, qh, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, model.config.rms_eps)
    return _mm(x, model.head).float()


def forward_decode(
    model: Transformer,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] position of the current token
    kv_cache: torch.Tensor,  # updated IN PLACE
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] int32 length INCLUDING the current token
    active: torch.Tensor,  # [B] bool
    decode_attention_fn: Optional[AttentionFn] = None,
) -> torch.Tensor:
    """Single-token decode with DEFERRED cache writes: every layer attends
    over (pool history + current-token K/V held in registers); the pool is
    written once at the end for all layers, in place. Returns logits
    [B, 1, V] f32. `decode_attention_fn` (q, kv, layer, tables, lens, k, v)
    overrides the plain history attention (the CUDA flash-decode kernel)."""
    config = model.config
    attn_fn = decode_attention_fn or paged_attention_decode_xla
    pos2 = positions[:, None]
    cos, sin = rope_tables(pos2, config.head_dim, config.rope_theta)
    x = model.embed[tokens][:, None, :]  # [B, 1, H]
    ks, vs = [], []
    for layer_idx, lp in enumerate(model.layers):
        h = rms_norm(x, lp["attn_norm"], config.rms_eps)
        q, k, v = _qkv(h, lp, config, cos, sin)
        attn = attn_fn(q, kv_cache, layer_idx, block_tables, kv_lens, k, v)
        ks.append(k)
        vs.append(v)
        x = x + _mm(attn, lp["wo"], k=2)
        x = x + _swiglu(rms_norm(x, lp["mlp_norm"], config.rms_eps), lp)
    write_kv_stack(kv_cache, torch.stack(ks), torch.stack(vs),
                   block_tables, pos2, active[:, None])
    return _logits(model, x)


def forward(
    model: Transformer,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]
    kv_cache: torch.Tensor,  # updated IN PLACE
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] kv length AFTER this chunk
    valid: Optional[torch.Tensor] = None,  # [B, T] bool
    attention_fn: Optional[AttentionFn] = None,
) -> torch.Tensor:
    """Unified chunk forward (prefill T > 1 or decode T = 1): each layer
    writes its K/V into the pool, then attends over the pool. Returns logits
    [B, T, V] f32."""
    config = model.config
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    attention = attention_fn or paged_attention_xla
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    x = model.embed[tokens]  # [B, T, H]
    for layer_idx, lp in enumerate(model.layers):
        h = rms_norm(x, lp["attn_norm"], config.rms_eps)
        q, k, v = _qkv(h, lp, config, cos, sin)
        write_kv_pages(kv_cache, layer_idx, k, v, block_tables, positions,
                       valid)
        attn = attention(q, kv_cache, layer_idx, block_tables, positions,
                         kv_lens)
        x = x + _mm(attn, lp["wo"], k=2)
        x = x + _swiglu(rms_norm(x, lp["mlp_norm"], config.rms_eps), lp)
    return _logits(model, x)
