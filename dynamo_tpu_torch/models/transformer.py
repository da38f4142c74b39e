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
writes KV (`write_kv_pages`, `write_kv_stack`, `forward`, `forward_decode`,
`forward_spec`) updates the pool IN PLACE.

Weight-only quantized projections (the JAX package's `models/quantize.py`
leaves) are `ops.Q8Weight` ({"q8", "qs"}, W8A16) and `ops.Q4Weight`
({"q4", "qs4", "qz4"}, W4A16) submodules in place of the dense tensors;
`_mm` sends them through `quant_matmul` (the CUDA dequant-GEMM kernels on
the card, their plain versions on the CPU), or through the `matmul_fn` a
caller passes. The KV pool is bf16, or int8 as a (values, scales) pair with
one bf16 scale per token (`make_kv_cache_int8`, `quantize_kv`).

Qwen3-style `qk_norm` is kept, so qwen3 configs run too. MoE, MLA, gpt-oss,
LoRA and multimodal splicing are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.q4_linear import Q4Weight, q4_matmul, q4_matmul_ref
from ..ops.q8_linear import Q8Weight, q8_matmul, q8_matmul_ref
from .config import ModelConfig

AttentionFn = Callable[..., torch.Tensor]
QuantWeight = Union[Q8Weight, Q4Weight]
# (x [M, K], quantized leaf) -> [M, N]: the kernel path or the plain one.
MatmulFn = Callable[[torch.Tensor, QuantWeight], torch.Tensor]
# A KV pool: bf16 [L, 2, P, ps, kh, hd], or int8 (values, scales [L, 2, P, ps]).
KVCache = Union[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]


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


def _leaf(value):
    """A dense tensor becomes a frozen Parameter; a quantized leaf stays the
    module it is."""
    if isinstance(value, torch.Tensor):
        return nn.Parameter(value, requires_grad=False)
    if not isinstance(value, (Q8Weight, Q4Weight)):
        raise TypeError(f"unexpected leaf {type(value).__name__}")
    return value


class Layer(nn.Module):
    """One decoder layer's leaves by name (`layer["wq"]`): dense tensors as
    Parameters, quantized projections as Q8Weight / Q4Weight submodules.
    Assigning a name replaces its leaf, which frees the old one."""

    def __init__(self, leaves: dict) -> None:
        super().__init__()
        for name, value in leaves.items():
            self[name] = value

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __setitem__(self, name: str, value) -> None:
        if name in self:
            delattr(self, name)
        setattr(self, name, _leaf(value))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]


class Transformer(nn.Module):
    """The weights of a dense GQA decoder, in the JAX package's layouts.

    `tree` has the JAX params' structure: {"embed", "final_norm",
    ["lm_head"], "layers": [{"attn_norm", "wq", "wk", "wv", "wo",
    "mlp_norm", "w_gate", "w_up", "w_down", ["q_norm", "k_norm"]}, ...]}
    with tensors, or quantized leaves (`Q8Weight` / `Q4Weight`) for the
    projections, as leaves. Inference only: nothing requires grad."""

    def __init__(self, config: ModelConfig, tree: dict) -> None:
        super().__init__()
        check_supported(config)
        self.config = config
        self.embed = _leaf(tree["embed"])
        self.final_norm = _leaf(tree["final_norm"])
        self.lm_head = (None if config.tie_embeddings
                        else _leaf(tree["lm_head"]))
        self.layers = nn.ModuleList(Layer(layer) for layer in tree["layers"])
        if len(self.layers) != config.n_layers:
            raise ValueError(f"{len(self.layers)} layers for a "
                             f"{config.n_layers}-layer config")

    def set_head(self, value) -> None:
        """Replace the untied output projection (frees the old one)."""
        del self.lm_head
        self.lm_head = _leaf(value)

    @property
    def head(self):
        """[h, V] output projection (the embedding, transposed, when tied),
        or its quantized leaf."""
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


# The reference broadcasts each token's scale over this many lanes (a TPU
# tiling artifact) and its int8 kernel needs head_dim equal to it; the port
# stores one scale per token but keeps the head_dim gate at the runner.
KV_SCALE_LANES = 128


def make_kv_cache_int8(config: ModelConfig, num_pages: int, page_size: int,
                       *, device: DeviceLike = "cuda"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed int8 pool: (values int8 [L, 2, P, ps, kh, hd], scales bf16
    [L, 2, P, ps]), one absmax scale per token shared by the kv heads."""
    check_supported(config)
    dev = resolve_device(device)
    values = torch.zeros(
        (config.n_layers, 2, num_pages, page_size, config.n_kv_heads,
         config.head_dim), dtype=torch.int8, device=dev)
    scales = torch.zeros((config.n_layers, 2, num_pages, page_size),
                         dtype=torch.bfloat16, device=dev)
    return values, scales


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., kh, hd] float -> (int8 [..., kh, hd], bf16 scale [...]): one
    symmetric absmax scale per token, shared across heads, rounded to bf16
    before the codes are computed against it (as the reference does)."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=(-2, -1))
    scale = (absmax / 127.0).to(torch.bfloat16).float()
    q = torch.round(x32 / scale.clamp_min(1e-12)[..., None, None])
    return q.clamp(-127, 127).to(torch.int8), scale.to(torch.bfloat16)


def _kv_parts(kv_cache: KVCache):
    """(values, scales) for either pool form (scales None for bf16)."""
    if isinstance(kv_cache, tuple):
        return kv_cache
    return kv_cache, None


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


def quant_matmul(x: torch.Tensor, w: QuantWeight) -> torch.Tensor:
    """x [M, K] @ a quantized leaf -> [M, N]: `ops.q8_matmul` /
    `ops.q4_matmul` (the CUDA kernels for CUDA tensors)."""
    if isinstance(w, Q4Weight):
        return q4_matmul(x, w.q4.reshape(w.q4.shape[0], -1), w.qs4, w.qz4)
    return q8_matmul(x, w.q8.reshape(x.shape[1], -1), w.qs.reshape(-1))


def quant_matmul_ref(x: torch.Tensor, w: QuantWeight) -> torch.Tensor:
    """The plain PyTorch versions of `quant_matmul`, on any device."""
    if isinstance(w, Q4Weight):
        return q4_matmul_ref(x, w.q4.reshape(w.q4.shape[0], -1), w.qs4, w.qz4)
    return q8_matmul_ref(x, w.q8.reshape(x.shape[1], -1), w.qs.reshape(-1))


def _mm(x: torch.Tensor, w, k: int = 1,
        matmul_fn: Optional[MatmulFn] = None) -> torch.Tensor:
    """Contract the last `k` dims of x with the first `k` dims of w (the JAX
    layouts make every projection a plain matmul). A quantized leaf goes
    through `matmul_fn` (default `quant_matmul`) as one [M, K] x [K, N]
    product, the reshapes of the reference's q8_einsum / q4_einsum."""
    lead = x.shape[:-k]
    fan_in = math.prod(x.shape[-k:])
    if isinstance(w, torch.Tensor):
        out = x.reshape(*lead, fan_in) @ w.reshape(fan_in, -1)
        return out.reshape(*lead, *w.shape[k:])
    x2 = x.reshape(-1, fan_in).contiguous()
    return (matmul_fn or quant_matmul)(x2, w).reshape(*lead, *w.out_axes)


def _swiglu(x: torch.Tensor, p, mm: Optional[MatmulFn] = None) -> torch.Tensor:
    gate = _mm(x, p["w_gate"], matmul_fn=mm)
    up = _mm(x, p["w_up"], matmul_fn=mm)
    return _mm(F.silu(gate) * up, p["w_down"], matmul_fn=mm)


def _qkv(h: torch.Tensor, lp, config: ModelConfig, cos: torch.Tensor,
         sin: torch.Tensor, mm: Optional[MatmulFn] = None):
    q = _mm(h, lp["wq"], matmul_fn=mm)
    k = _mm(h, lp["wk"], matmul_fn=mm)
    v = _mm(h, lp["wv"], matmul_fn=mm)
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
    kv_cache: KVCache,  # [L, 2, P, ps, kh, hd] or int8 pair, updated IN PLACE
    layer: int,
    k: torch.Tensor,  # [B, T, kh, hd]
    v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    positions: torch.Tensor,  # [B, T] absolute positions
    valid: torch.Tensor,  # [B, T] bool
) -> KVCache:
    """Scatter one layer's K/V into the pool in place (quantized per token
    for an int8 pool); returns the pool."""
    values, scales = _kv_parts(kv_cache)
    pages, offs = _page_slots(values, block_tables, positions, valid)
    n = pages.shape[0]
    if scales is not None:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        values[layer, 0, pages, offs] = kq.reshape(n, *kq.shape[2:])
        values[layer, 1, pages, offs] = vq.reshape(n, *vq.shape[2:])
        scales[layer, 0, pages, offs] = ks.reshape(n)
        scales[layer, 1, pages, offs] = vs.reshape(n)
        return kv_cache
    values[layer, 0, pages, offs] = k.reshape(n, *k.shape[2:]).to(values.dtype)
    values[layer, 1, pages, offs] = v.reshape(n, *v.shape[2:]).to(values.dtype)
    return kv_cache


def write_kv_stack(
    kv_cache: KVCache,  # [L, 2, P, ps, kh, hd] or int8 pair, updated IN PLACE
    k_stack: torch.Tensor,  # [L, B, T, kh, hd]
    v_stack: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, T]
    valid: torch.Tensor,  # [B, T]
) -> KVCache:
    """Scatter every layer's K/V chunk into the pool in one shot (the
    deferred decode write-back), in place; returns the pool."""
    values, scales = _kv_parts(kv_cache)
    pages, offs = _page_slots(values, block_tables, positions, valid)
    n_layers, n = k_stack.shape[0], pages.shape[0]
    if scales is not None:
        (kq, ks), (vq, vs) = quantize_kv(k_stack), quantize_kv(v_stack)
        values[:, 0, pages, offs] = kq.reshape(n_layers, n, *kq.shape[3:])
        values[:, 1, pages, offs] = vq.reshape(n_layers, n, *vq.shape[3:])
        scales[:, 0, pages, offs] = ks.reshape(n_layers, n)
        scales[:, 1, pages, offs] = vs.reshape(n_layers, n)
        return kv_cache
    values[:, 0, pages, offs] = k_stack.reshape(
        n_layers, n, *k_stack.shape[3:]).to(values.dtype)
    values[:, 1, pages, offs] = v_stack.reshape(
        n_layers, n, *v_stack.shape[3:]).to(values.dtype)
    return kv_cache


def _gather_pages(kv_cache: KVCache, layer, block_tables, kv: int):
    """One layer's K (kv=0) or V (kv=1) rows of the table's pages, f32
    [B, ctx, kh, hd], dequantized by their per-token scales for int8."""
    values, scales = _kv_parts(kv_cache)
    b, max_pages = block_tables.shape
    ps, kh, hd = values.shape[3:]
    tables = block_tables.long()
    pages = values[layer, kv][tables].reshape(b, max_pages * ps, kh, hd).float()
    if scales is not None:
        pages = pages * scales[layer, kv][tables].reshape(
            b, max_pages * ps, 1, 1).float()
    return pages


def paged_attention_xla(
    q: torch.Tensor,  # [B, T, qh, hd]
    kv_cache: KVCache,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, T] absolute query positions
    kv_lens: torch.Tensor,  # [B] kv tokens visible (incl. this chunk)
) -> torch.Tensor:
    """Plain paged attention (the prefill path): gather the sequence's
    pages, masked softmax in f32."""
    b, t, qh, hd = q.shape
    kh = _kv_parts(kv_cache)[0].shape[4]
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


def paged_attention_spec_xla(
    q: torch.Tensor,  # [B, T, qh, hd] T chunk queries per sequence
    kv_cache: KVCache,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B] committed length INCLUDING chunk token 0
    k_cur: torch.Tensor,  # [B, T, kh, hd] chunk K (not yet cached)
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Plain speculative-verification attention: every chunk query attends
    the cached history (positions < kv_len - 1) plus the in-register chunk
    tokens causally (token j <= query i). T == 1 is single-token decode
    (`paged_attention_decode_xla`)."""
    b, t, qh, hd = q.shape
    kh = _kv_parts(kv_cache)[0].shape[4]
    k = _gather_pages(kv_cache, layer, block_tables, 0)
    v = _gather_pages(kv_cache, layer, block_tables, 1)
    ctx = k.shape[1]
    qg = q.reshape(b, t, kh, qh // kh, hd).float()
    hist = torch.einsum("btkgh,bskh->btkgs", qg, k) / math.sqrt(hd)
    # History: positions 0 .. kv_len-2 (the chunk starts at kv_len-1).
    hist_mask = (torch.arange(ctx, device=q.device)[None, :]
                 < (kv_lens.long()[:, None] - 1))
    hist = hist.masked_fill(~hist_mask[:, None, None, None, :], -1e30)
    cur = torch.einsum("btkgh,bskh->btkgs", qg, k_cur.float()) / math.sqrt(hd)
    pos = torch.arange(t, device=q.device)
    causal = pos[None, :] <= pos[:, None]  # [Tq, Tk]
    cur = cur.masked_fill(~causal[None, :, None, None, :], -1e30)
    probs = torch.softmax(torch.cat([hist, cur], dim=-1), dim=-1)
    out = (torch.einsum("btkgs,bskh->btkgh", probs[..., :ctx], v)
           + torch.einsum("btkgs,bskh->btkgh", probs[..., ctx:],
                          v_cur.float()))
    return out.reshape(b, t, qh, hd).to(q.dtype)


def paged_attention_decode_xla(
    q: torch.Tensor,  # [B, 1, qh, hd]
    kv_cache: KVCache,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B] kv length INCLUDING the current token
    k_cur: torch.Tensor,  # [B, 1, kh, hd] current token's K (not yet cached)
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Plain decode attention over the cached history plus the in-register
    current token (the pool is written once per step, after all layers):
    the T == 1 case of `paged_attention_spec_xla`."""
    return paged_attention_spec_xla(q, kv_cache, layer, block_tables, kv_lens,
                                    k_cur, v_cur)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _logits(model: Transformer, x: torch.Tensor,
            mm: Optional[MatmulFn] = None) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, model.config.rms_eps)
    return _mm(x, model.head, matmul_fn=mm).float()


def _forward_deferred(model, tokens, positions, kv_cache, block_tables,
                      kv_lens, active, attn_fn, matmul_fn):
    """Chunk forward with DEFERRED cache writes (tokens / positions [B, T]):
    every layer attends over (pool history + the chunk's K/V held in
    registers) through `attn_fn`; the pool is written once at the end for
    all layers, in place. Returns logits [B, T, V] f32."""
    config = model.config
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    x = model.embed[tokens]  # [B, T, H]
    ks, vs = [], []
    for layer_idx, lp in enumerate(model.layers):
        h = rms_norm(x, lp["attn_norm"], config.rms_eps)
        q, k, v = _qkv(h, lp, config, cos, sin, matmul_fn)
        attn = attn_fn(q, kv_cache, layer_idx, block_tables, kv_lens, k, v)
        ks.append(k)
        vs.append(v)
        x = x + _mm(attn, lp["wo"], k=2, matmul_fn=matmul_fn)
        x = x + _swiglu(rms_norm(x, lp["mlp_norm"], config.rms_eps), lp,
                        matmul_fn)
    write_kv_stack(kv_cache, torch.stack(ks), torch.stack(vs), block_tables,
                   positions, active[:, None].expand(positions.shape))
    return _logits(model, x, matmul_fn)


def forward_decode(
    model: Transformer,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] position of the current token
    kv_cache: KVCache,  # updated IN PLACE
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] int32 length INCLUDING the current token
    active: torch.Tensor,  # [B] bool
    decode_attention_fn: Optional[AttentionFn] = None,
    matmul_fn: Optional[MatmulFn] = None,
) -> torch.Tensor:
    """Single-token decode with DEFERRED cache writes: every layer attends
    over (pool history + current-token K/V held in registers); the pool is
    written once at the end for all layers, in place. Returns logits
    [B, 1, V] f32. `decode_attention_fn` (q, kv, layer, tables, lens, k, v)
    overrides the plain history attention (the CUDA flash-decode kernel);
    `matmul_fn` overrides `quant_matmul` for quantized leaves."""
    return _forward_deferred(
        model, tokens[:, None], positions[:, None], kv_cache, block_tables,
        kv_lens, active, decode_attention_fn or paged_attention_decode_xla,
        matmul_fn)


def forward_spec(
    model: Transformer,
    tokens: torch.Tensor,  # [B, T] chunk token 0 = last committed token
    positions: torch.Tensor,  # [B, T] absolute positions
    kv_cache: KVCache,  # updated IN PLACE
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] committed length INCLUDING chunk token 0
    active: torch.Tensor,  # [B] bool
    spec_attention_fn: Optional[AttentionFn] = None,
    matmul_fn: Optional[MatmulFn] = None,
) -> torch.Tensor:
    """Speculative batched verification: `forward_decode` generalized to T
    tokens per slot, so one weight-streaming pass scores all T candidate
    positions. Deferred cache writes exactly like decode: rejected positions
    leave stale KV past the committed length that the next step's chunk
    rewrites before it can be attended. Returns logits [B, T, V] f32.
    `spec_attention_fn` (q, kv, layer, tables, lens, k, v) overrides the
    plain `paged_attention_spec_xla` (the folded whole-pool kernel)."""
    return _forward_deferred(
        model, tokens, positions, kv_cache, block_tables, kv_lens, active,
        spec_attention_fn or paged_attention_spec_xla, matmul_fn)


def forward(
    model: Transformer,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]
    kv_cache: KVCache,  # updated IN PLACE
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_lens: torch.Tensor,  # [B] kv length AFTER this chunk
    valid: Optional[torch.Tensor] = None,  # [B, T] bool
    attention_fn: Optional[AttentionFn] = None,
    matmul_fn: Optional[MatmulFn] = None,
    last_idx: Optional[torch.Tensor] = None,  # [B] int64
) -> torch.Tensor:
    """Unified chunk forward (prefill T > 1 or decode T = 1): each layer
    writes its K/V into the pool, then attends over the pool. Returns logits
    [B, T, V] f32, or with `last_idx` the rows x[b, last_idx[b]] only,
    [B, 1, V]: the final norm and the head then run on the sampled rows
    alone (each row's values are the full logits' row)."""
    config = model.config
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    attention = attention_fn or paged_attention_xla
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    x = model.embed[tokens]  # [B, T, H]
    for layer_idx, lp in enumerate(model.layers):
        h = rms_norm(x, lp["attn_norm"], config.rms_eps)
        q, k, v = _qkv(h, lp, config, cos, sin, matmul_fn)
        write_kv_pages(kv_cache, layer_idx, k, v, block_tables, positions,
                       valid)
        attn = attention(q, kv_cache, layer_idx, block_tables, positions,
                         kv_lens)
        x = x + _mm(attn, lp["wo"], k=2, matmul_fn=matmul_fn)
        x = x + _swiglu(rms_norm(x, lp["mlp_norm"], config.rms_eps), lp,
                        matmul_fn)
    if last_idx is not None:
        x = torch.gather(x, 1, last_idx.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    return _logits(model, x, matmul_fn)
