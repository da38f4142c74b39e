"""Decoder transformers over a paged KV pool, in PyTorch: dense, MoE,
gpt-oss and MLA.

Port of the dense, MoE, gpt-oss and MLA branches of
`dynamo_tpu/models/transformer.py`. The weights
live in a `Transformer` module in the JAX package's layouts (`wq [h, qh, hd]`,
`wk/wv [h, kh, hd]`, `wo [qh, hd, h]`, `w_gate/w_up [h, m]`, `w_down [m, h]`,
`embed [V, h]`, `lm_head [h, V]`), so every projection is
`x @ w.reshape(fan_in, -1)` with no transposes and the JAX package's params
carry over leaf for leaf (`models/convert.py`).

The paged KV pool is one tensor [layers, kv_dims, pages, page_size,
cache_heads, cache_head_dim]: [L, 2, P, ps, kv_heads, hd] for standard
attention, [L, 1, P, ps, 1, dc + rhd] for MLA's latent pool; page 0 is a
scratch page that block tables point unused slots at. Unlike the
JAX package, whose functions return a new cache, every function here that
writes KV (`write_kv_pages`, `write_kv_stack`, `write_latent_pages`,
`forward`, `forward_decode`, `forward_spec`) updates the pool IN PLACE.

Weight-only quantized projections (the JAX package's `models/quantize.py`
leaves) are `ops.Q8Weight` ({"q8", "qs"}, W8A16) and `ops.Q4Weight`
({"q4", "qs4", "qz4"}, W4A16) submodules in place of the dense tensors;
`_mm` sends them through `quant_matmul` (the CUDA dequant-GEMM kernels on
the card, their plain versions on the CPU), or through the `matmul_fn` a
caller passes. The KV pool is bf16, or int8 as a (values, scales) pair with
one bf16 scale per token (`make_kv_cache_int8`, `quantize_kv`).

Qwen3-style `qk_norm` is kept, so qwen3 configs run too. MoE layers (Qwen3-MoE,
Mixtral, and the DeepSeek routing variants: sigmoid scoring, group-limited
selection, the routed scale, shared experts, `first_k_dense` stacks) route
through `models.moe`: a layer holding a `router` runs the capacity dispatch
in place of the dense SwiGLU, as the reference selects per layer. A MoE
layer holds no dense MLP leaves (the JAX package keeps unused ones).

gpt-oss (`config.is_gptoss`) runs `forward` only, as the reference runs it:
biased q/k/v projections, YaRN rope (`yarn_rope_tables`, `rope_gptoss`),
the write-then-attend sink attention with a sliding window on even layers
(`paged_attention_sinks_xla`, plain PyTorch: the reference runs no kernel
for it and ignores `attention_fn`), `bo` after `wo`, and the dense-over-
experts clipped SwiGLU (`models.moe.moe_gptoss`). The deferred-write
`forward_decode` / `forward_spec` refuse it.

MLA (`config.is_mla`, the DeepSeek family) also runs `forward` only:
`mla_attention_xla` writes one latent row a token (`write_latent_pages`:
the normed `c_kv` and the rotated shared `k_rope`), then attends with the
absorbed weights (`q_nope . w_uk` against the gathered latents, f32 scores
and softmax, the latent context through `w_uv`), in plain PyTorch as the
reference computes it in plain XLA, ignoring `attention_fn`. With a q LoRA
rank (the V3 shape) the query is `rms(x @ w_dq) @ w_uq`. Multimodal
splicing is not ported yet and raises.

Multi-LoRA (`LORA_TARGETS`, `lora_target_dims`, `init_lora_pack`,
`_lora_delta`): every forward takes an adapter slot pack (`lora`, a list of
per-layer dicts of `{"a": [S, din, r], "b": [S, r, dout]}`, slot 0 all
zero: the base model) and a slot per row (`lora_idx` [B]), and adds each
target's low-rank delta right after the base projection, as the reference
does: after `quant_matmul` on a quantized leaf, before qk_norm and the rope
for q / k / v, after `bo` for `wo`. The deltas are the reference's plain
products (each row's factors gathered by its slot, then two `torch.bmm`),
so one step serves any mix of adapters. MLA takes the `wq` delta as
`q_extra`, added to the query before its split into the no-rope and rope
parts. gpt-oss adapts `wo` only: the reference's gpt-oss block never applies
`wq` / `wk` / `wv` deltas, so the port's `lora_target_dims` leaves them out
and an adapter that holds them is refused at load.
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
from .moe import moe, moe_gptoss

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
    if config.image_token_id >= 0:
        raise NotImplementedError(
            f"{config.name}: multimodal embedding splice not ported yet")


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
    projections, as leaves. A MoE layer holds `router`, `e_gate`, `e_up`,
    `e_down` (and `e_bias`, `s_gate`, `s_up`, `s_down` where its config
    has them; see `models.moe`) in place of the dense MLP leaves. A gpt-oss
    layer holds, beside the attention and norm leaves, `bq [qh, hd]`,
    `bk / bv [kh, hd]`, `bo [h]`, `sinks [qh]`, `router [h, e]`,
    `router_bias [e]`, `e_gate_up [e, h, 2em]` (gate and up interleaved
    along the last axis), `e_gate_up_bias [e, 2em]`, `e_down [e, em, h]`
    and `e_down_bias [e, h]`, and no dense MLP leaves. An MLA layer holds
    `w_dkv [h, dc]`, `w_kr [h, rhd]`, `kv_norm [dc]`, `w_uk [dc, qh, nhd]`,
    `w_uv [dc, qh, vhd]` and `wo [qh, vhd, h]`, with `wq [h, qh, nhd + rhd]`
    or, given a q LoRA rank, `w_dq [h, qr]`, `q_a_norm [qr]` and
    `w_uq [qr, qh, nhd + rhd]`; its MLP is dense or MoE by layer.
    Inference only: nothing requires grad."""

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
    The draws differ from the JAX package's for the same seed. A MoE layer
    (`config.layer_is_moe`) gets the router, the expert stacks, a zero f32
    `e_bias` for sigmoid scoring and the shared experts' projections, and no
    dense MLP leaves. A gpt-oss layer gets the reference's leaves at its
    scales: the biases at 0.02 of a projection's, `sinks` at fan-in 1, and
    zero router and expert biases. An MLA layer gets the reference's latent
    attention leaves (the q LoRA path where the config has a rank) in place
    of wq / wk / wv / wo. On the `meta` device nothing is drawn: the tree
    holds the leaves' shapes and dtypes only (the weight plane's template)."""
    check_supported(config)
    meta = torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    dtype = torch_dtype(config.dtype)
    gen = None
    if not meta:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    h, hd = config.hidden, config.head_dim
    qh, kh, m = config.n_q_heads, config.n_kv_heads, config.mlp_hidden

    def dense(shape, fan_in):
        if meta:
            return torch.empty(shape, device=dev, dtype=dtype)
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    def mla():
        """An MLA layer's attention and norm leaves, at the reference's
        scales."""
        dc, qr = config.mla_kv_lora_rank, config.mla_q_lora_rank
        nhd, rhd = config.mla_nope_head_dim, config.mla_rope_head_dim
        vhd = config.mla_v_head_dim
        p = {
            "attn_norm": ones(h),
            "w_dkv": dense((h, dc), h),
            "w_kr": dense((h, rhd), h),
            "kv_norm": ones(dc),
            "w_uk": dense((dc, qh, nhd), dc),
            "w_uv": dense((dc, qh, vhd), dc),
            "wo": dense((qh, vhd, h), qh * vhd),
        }
        if qr:
            p["w_dq"] = dense((h, qr), h)
            p["q_a_norm"] = ones(qr)
            p["w_uq"] = dense((qr, qh, nhd + rhd), qr)
        else:
            p["wq"] = dense((h, qh, nhd + rhd), h)
        p["mlp_norm"] = ones(h)
        return p

    def layer(layer_idx):
        if config.is_mla:
            return mlp(mla(), layer_idx)
        p = {
            "attn_norm": ones(h),
            "wq": dense((h, qh, hd), h),
            "wk": dense((h, kh, hd), h),
            "wv": dense((h, kh, hd), h),
            "wo": dense((qh, hd, h), qh * hd),
            "mlp_norm": ones(h),
        }
        if config.qk_norm:
            p["q_norm"] = ones(hd)
            p["k_norm"] = ones(hd)
        if config.is_gptoss:
            e, em = config.n_experts, config.expert_mlp_hidden or m
            zeros = lambda *shape: torch.zeros(  # noqa: E731
                shape, device=dev, dtype=dtype)
            p.update({
                "bq": dense((qh, hd), h) * 0.02,
                "bk": dense((kh, hd), h) * 0.02,
                "bv": dense((kh, hd), h) * 0.02,
                "bo": dense((h,), h) * 0.02,
                "sinks": dense((qh,), 1),
                "router": dense((h, e), h),
                "router_bias": zeros(e),
                "e_gate_up": dense((e, h, 2 * em), h),
                "e_gate_up_bias": zeros(e, 2 * em),
                "e_down": dense((e, em, h), em),
                "e_down_bias": zeros(e, h),
            })
            return p
        return mlp(p, layer_idx)

    def mlp(p, layer_idx):
        """The dense SwiGLU's leaves, or on a MoE layer the router, the
        expert stacks and the shared experts'."""
        if not config.layer_is_moe(layer_idx):
            p["w_gate"] = dense((h, m), h)
            p["w_up"] = dense((h, m), h)
            p["w_down"] = dense((m, h), m)
            return p
        e, em = config.n_experts, config.expert_mlp_hidden or m
        p["router"] = dense((h, e), h)
        if config.moe_scoring == "sigmoid":
            p["e_bias"] = torch.zeros(e, device=dev, dtype=torch.float32)
        p["e_gate"] = dense((e, h, em), h)
        p["e_up"] = dense((e, h, em), h)
        p["e_down"] = dense((e, em, h), em)
        if config.n_shared_experts:
            sm = config.n_shared_experts * em
            p["s_gate"] = dense((h, sm), h)
            p["s_up"] = dense((h, sm), h)
            p["s_down"] = dense((sm, h), sm)
        return p

    tree = {
        "embed": dense((config.vocab_size, h), h),
        "final_norm": ones(h),
        "layers": [layer(i) for i in range(config.n_layers)],
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
    [L, 2, P, ps]), one absmax scale per token shared by the kv heads.
    Standard attention only: MLA raises, as the reference asserts."""
    check_supported(config)
    if config.is_mla:
        raise ValueError("int8 KV targets standard-attention models")
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
    """Zeroed pool [layers, kv_dims, pages, page_size, cache_heads,
    cache_head_dim]: [L, 2, P, ps, kv_heads, head_dim] for standard
    attention, [L, 1, P, ps, 1, dc + rhd] for MLA's latent pool. Page 0 is
    the reserved scratch page."""
    check_supported(config)
    return torch.zeros(
        (config.n_layers, config.kv_cache_kv_dims, num_pages, page_size,
         config.kv_cache_heads, config.kv_cache_head_dim),
        dtype=torch_dtype(dtype or config.dtype),
        device=resolve_device(device))


# ---------------------------------------------------------------------------
# Multi-LoRA (adapter slots, one step for any mix)
# ---------------------------------------------------------------------------

# Projections a LoRA adapter may target (dense path; expert weights and the
# MLA latent projections are out of scope, as in the reference).
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# A slot pack: per layer, target -> {"a": [S, din, r], "b": [S, r, dout]}.
LoraPack = list[dict[str, dict[str, torch.Tensor]]]


def lora_target_dims(config: ModelConfig) -> dict[str, tuple[int, int]]:
    """(din, dout) of every target this model family applies; a target
    absent here is refused at load, never silently dropped. MLA has no dense
    wk / wv (and no dense wq with a q LoRA rank); a MoE layer has no dense
    MLP; gpt-oss adapts `wo` only, since the reference's gpt-oss attention
    never applies wq / wk / wv deltas."""
    h, hd = config.hidden, config.head_dim
    qh, kh, m = config.n_q_heads, config.n_kv_heads, config.mlp_hidden
    if config.is_mla:
        dims = {"wo": (qh * config.mla_v_head_dim, h)}
        if not config.mla_q_lora_rank:
            dims["wq"] = (h, qh * (config.mla_nope_head_dim
                                   + config.mla_rope_head_dim))
    elif config.is_gptoss:
        dims = {"wo": (qh * hd, h)}
    else:
        dims = {"wq": (h, qh * hd), "wk": (h, kh * hd), "wv": (h, kh * hd),
                "wo": (qh * hd, h)}
    if not config.n_experts:
        dims.update({"w_gate": (h, m), "w_up": (h, m), "w_down": (m, h)})
    return dims


def init_lora_pack(config: ModelConfig, max_loras: int, rank: int, *,
                   device: DeviceLike = "cuda") -> LoraPack:
    """Zeroed adapter slots in the model dtype: for every layer and
    target, a [S, din, rank] and b [S, rank, dout] with S = max_loras + 1.
    Slot 0 stays zero (the base model), so a row without an adapter runs
    the same step with lora_idx 0. Slots are written in place
    (`ModelRunner.set_lora_slot`): the step graphs captured these
    tensors' storage."""
    dev = resolve_device(device)
    dtype = torch_dtype(config.dtype)
    s = max_loras + 1
    dims = lora_target_dims(config)
    return [{t: {"a": torch.zeros((s, din, rank), dtype=dtype, device=dev),
                 "b": torch.zeros((s, rank, dout), dtype=dtype, device=dev)}
             for t, (din, dout) in dims.items()}
            for _ in range(config.n_layers)]


def _lora_delta(x: torch.Tensor, entry: dict,
                idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, din]; entry {a [S, din, r], b [S, r, dout]}; idx [B] the
    slot of each row. Each row's factors are gathered, then two batched
    products, as the reference's einsums: returns [B, T, dout]."""
    idx = idx.long()
    low = torch.bmm(x, entry["a"][idx])  # [B, T, r]
    return torch.bmm(low, entry["b"][idx])


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


def yarn_rope_tables(config: ModelConfig, *, device: DeviceLike = "cpu"
                     ) -> tuple[torch.Tensor, float]:
    """YaRN-scaled inverse frequencies and the cos/sin attention factor, as
    HF `_compute_yarn_parameters` gives them for gpt-oss (truncate=False,
    attention_factor = 0.1 ln(factor) + 1). Returns (inv_freq [hd/2] f32 on
    `device`, attention_factor)."""
    dim = config.head_dim
    base = config.rope_theta
    factor = config.rope_yarn_factor
    orig_max = config.rope_yarn_orig_max

    def correction_dim(num_rot):
        return (dim * math.log(orig_max / (num_rot * 2 * math.pi))
                ) / (2 * math.log(base))

    low = max(correction_dim(config.rope_yarn_beta_fast), 0)
    high = min(correction_dim(config.rope_yarn_beta_slow), dim - 1)
    if low == high:
        high += 0.001
    dev = torch.device(device)
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=dev) / dim)
    extrap = 1.0 / pos_freqs
    interp = 1.0 / (factor * pos_freqs)
    ramp = torch.clip(
        (torch.arange(dim // 2, dtype=torch.float32, device=dev) - low)
        / (high - low), 0, 1)
    extrap_factor = 1.0 - ramp
    inv_freq = interp * (1 - extrap_factor) + extrap * extrap_factor
    return inv_freq, 0.1 * math.log(factor) + 1.0


def rope_gptoss_tables(positions: torch.Tensor, config: ModelConfig
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [..., T, 1, hd/2] f32 for `positions` [..., T], YaRN-scaled
    and multiplied by the attention factor before the rotation; computed
    once a forward, as `rope_tables`."""
    inv_freq, att = yarn_rope_tables(config, device=positions.device)
    angles = positions[..., None].float() * inv_freq
    return ((torch.cos(angles) * att)[..., None, :],
            (torch.sin(angles) * att)[..., None, :])


def rope_gptoss(x: torch.Tensor, positions: torch.Tensor,
                config: ModelConfig) -> torch.Tensor:
    """Rotary embedding with YaRN scaling: `rope`'s half-split rotation with
    `rope_gptoss_tables`' cos and sin."""
    return apply_rope(x, *rope_gptoss_tables(positions, config))


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


def _swiglu(x: torch.Tensor, p, mm: Optional[MatmulFn] = None,
            ll: Optional[dict] = None,
            lora_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SwiGLU MLP; with `ll` (a layer's slot pack) each projection gets
    its rows' LoRA deltas after the base product."""
    gate = _mm(x, p["w_gate"], matmul_fn=mm)
    up = _mm(x, p["w_up"], matmul_fn=mm)
    if ll is not None:
        gate = gate + _lora_delta(x, ll["w_gate"], lora_idx)
        up = up + _lora_delta(x, ll["w_up"], lora_idx)
    act = F.silu(gate) * up
    down = _mm(act, p["w_down"], matmul_fn=mm)
    if ll is not None:
        down = down + _lora_delta(act, ll["w_down"], lora_idx)
    return down


def _mlp(x: torch.Tensor, lp, config: ModelConfig,
         mm: Optional[MatmulFn] = None, ll: Optional[dict] = None,
         lora_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block after attention, on the residual x: gpt-oss's dense-over-
    experts block, the routed experts on a layer that holds a router
    (stacks may mix dense and MoE layers), else the dense SwiGLU (with the
    MLP targets' LoRA deltas where the pack `ll` holds them)."""
    h = rms_norm(x, lp["mlp_norm"], config.rms_eps)
    if config.is_gptoss:
        return moe_gptoss(h, lp, config)
    if "router" in lp:
        return moe(h, lp, config)
    return _swiglu(h, lp, mm, ll if ll and "w_gate" in ll else None,
                   lora_idx)


def _qkv(h: torch.Tensor, lp, config: ModelConfig, cos: torch.Tensor,
         sin: torch.Tensor, mm: Optional[MatmulFn] = None,
         ll: Optional[dict] = None,
         lora_idx: Optional[torch.Tensor] = None):
    """q, k, v of the normed residual h, rotated; a layer holding biases
    (gpt-oss) adds them in the model dtype before the rope, and a pack
    holding `wq` (`ll`) adds the rows' q / k / v LoRA deltas before the
    norms and the rope."""
    q = _mm(h, lp["wq"], matmul_fn=mm)
    k = _mm(h, lp["wk"], matmul_fn=mm)
    v = _mm(h, lp["wv"], matmul_fn=mm)
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if ll and "wq" in ll:
        q = q + _lora_delta(h, ll["wq"], lora_idx).reshape(q.shape)
        k = k + _lora_delta(h, ll["wk"], lora_idx).reshape(k.shape)
        v = v + _lora_delta(h, ll["wv"], lora_idx).reshape(v.shape)
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


def paged_attention_sinks_xla(
    q: torch.Tensor,  # [B, T, qh, hd]
    kv_cache: KVCache,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, T]
    kv_lens: torch.Tensor,  # [B]
    sinks: torch.Tensor,  # [qh] learned sink logits
    window: int,  # 0 = full attention
) -> torch.Tensor:
    """gpt-oss attention: a per-head SINK logit joins each row's softmax as
    one more column whose probability is then dropped, so attention mass can
    park on the sink; on a sliding layer a key must also lie within `window`
    of the query (kv position > query position - window)."""
    b, t, qh, hd = q.shape
    kh = _kv_parts(kv_cache)[0].shape[4]
    k = _gather_pages(kv_cache, layer, block_tables, 0)
    v = _gather_pages(kv_cache, layer, block_tables, 1)
    ctx = k.shape[1]
    group = qh // kh
    qg = q.reshape(b, t, kh, group, hd).float()
    scores = torch.einsum("btkgh,bskh->btkgs", qg, k) / math.sqrt(hd)
    kv_pos = torch.arange(ctx, device=q.device)[None, None, :]
    mask = ((kv_pos <= positions[..., None])
            & (kv_pos < kv_lens.long()[:, None, None]))
    if window:
        mask = mask & (kv_pos > positions[..., None] - window)
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    sink = sinks.float().reshape(1, 1, kh, group, 1)
    combined = torch.cat([scores, sink.expand(b, t, kh, group, 1)], dim=-1)
    combined = combined - combined.amax(dim=-1, keepdim=True)
    probs = torch.softmax(combined, dim=-1)[..., :-1]  # drop the sink
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


def write_latent_pages(
    kv_cache: torch.Tensor,  # [L, 1, P, ps, 1, dc+rhd], updated IN PLACE
    layer: int,
    latent: torch.Tensor,  # [B, T, dc+rhd] c_kv ++ k_rope per token
    block_tables: torch.Tensor,  # [B, max_pages] int32
    positions: torch.Tensor,  # [B, T]
    valid: torch.Tensor,  # [B, T] bool
) -> torch.Tensor:
    """MLA's cache write: one compressed latent row a token, in place;
    invalid (padding) tokens go to the scratch page 0. Returns the pool."""
    pages, offs = _page_slots(kv_cache, block_tables, positions, valid)
    kv_cache[layer, 0, pages, offs, 0] = latent.reshape(
        pages.shape[0], -1).to(kv_cache.dtype)
    return kv_cache


def mla_attention_xla(
    x: torch.Tensor,  # [B, T, H], attention-normed
    lp,
    config: ModelConfig,
    kv_cache: torch.Tensor,  # [L, 1, P, ps, 1, dc+rhd], updated IN PLACE
    layer: int,
    block_tables: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, T]
    kv_lens: torch.Tensor,  # [B] kv length AFTER this chunk
    valid: torch.Tensor,  # [B, T] bool
    rope_cos_sin: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    q_extra: Optional[torch.Tensor] = None,  # [B, T, qh*(nhd+rhd)] LoRA delta
) -> torch.Tensor:
    """MLA with weight absorption, the reference's `_mla_attention_block`:
    the chunk's latents (`rms(x @ w_dkv)` ++ the rotated `x @ w_kr`) are
    written first; the queries' no-rope part is projected into latent space
    (`q_nope . w_uk`), so scores and context are computed against the
    gathered latent pages of the whole table, in f32, and no per-head K/V
    of past tokens is ever built. The latent context goes through `w_uv`
    in x's dtype. `rope_cos_sin` are `rope_tables` at the rope head dim
    (computed here when not given). `q_extra`, the rows' `wq` LoRA delta,
    joins the query before its split into the no-rope and rope parts.
    Returns [B, T, qh, vhd]."""
    b = x.shape[0]
    nhd, rhd = config.mla_nope_head_dim, config.mla_rope_head_dim
    dc = config.mla_kv_lora_rank
    scale = 1.0 / math.sqrt(config.mla_qk_head_dim)
    cos, sin = rope_cos_sin or rope_tables(positions, rhd, config.rope_theta)
    if "w_dq" in lp:  # the V3 query low-rank path
        q = _mm(rms_norm(_mm(x, lp["w_dq"]), lp["q_a_norm"], config.rms_eps),
                lp["w_uq"])
    else:
        q = _mm(x, lp["wq"])  # [B, T, qh, nhd + rhd]
    if q_extra is not None:
        q = q + q_extra.reshape(q.shape)
    q_nope, q_rope = q[..., :nhd], apply_rope(q[..., nhd:], cos, sin)
    c_kv = rms_norm(_mm(x, lp["w_dkv"]), lp["kv_norm"], config.rms_eps)
    k_rope = apply_rope(_mm(x, lp["w_kr"])[:, :, None, :], cos, sin)[:, :, 0]
    write_latent_pages(kv_cache, layer, torch.cat([c_kv, k_rope], dim=-1),
                       block_tables, positions, valid)
    q_lat = torch.einsum("btqn,dqn->btqd", q_nope, lp["w_uk"])
    ctx = block_tables.shape[1] * kv_cache.shape[3]
    lat = kv_cache[layer, 0][block_tables.long()].reshape(b, ctx, dc + rhd)
    ckv, kr = lat[..., :dc].float(), lat[..., dc:].float()
    scores = (torch.einsum("btqd,bsd->btqs", q_lat.float(), ckv)
              + torch.einsum("btqr,bsr->btqs", q_rope.float(), kr)) * scale
    kv_pos = torch.arange(ctx, device=x.device)[None, None, :]
    mask = ((kv_pos <= positions[..., None])
            & (kv_pos < kv_lens.long()[:, None, None]))
    scores = scores.masked_fill(~mask[:, :, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("btqs,bsd->btqd", probs, ckv)  # [B, T, qh, dc]
    return torch.einsum("btqd,dqv->btqv", ctx_lat.to(x.dtype), lp["w_uv"])


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _logits(model: Transformer, x: torch.Tensor,
            mm: Optional[MatmulFn] = None) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, model.config.rms_eps)
    return _mm(x, model.head, matmul_fn=mm).float()


def _attn_out(attn: torch.Tensor, lp, mm: Optional[MatmulFn] = None,
              ll: Optional[dict] = None,
              lora_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The output projection, plus `bo` on a layer that holds it, then the
    rows' `wo` LoRA delta where the pack `ll` holds it."""
    out = _mm(attn, lp["wo"], k=2, matmul_fn=mm)
    if "bo" in lp:
        out = out + lp["bo"]
    if ll and "wo" in ll:
        b, t = attn.shape[:2]
        out = out + _lora_delta(attn.reshape(b, t, -1), ll["wo"], lora_idx)
    return out


def _layer_pack(lora: Optional[LoraPack], layer_idx: int) -> dict:
    """One layer's slot pack (empty without adapters)."""
    return lora[layer_idx] if lora is not None else {}


def _forward_deferred(model, tokens, positions, kv_cache, block_tables,
                      kv_lens, active, attn_fn, matmul_fn, lora, lora_idx):
    """Chunk forward with DEFERRED cache writes (tokens / positions [B, T]):
    every layer attends over (pool history + the chunk's K/V held in
    registers) through `attn_fn`; the pool is written once at the end for
    all layers, in place. Returns logits [B, T, V] f32. gpt-oss is refused:
    its sink attention runs in the unified `forward` only, as the
    reference's runner runs it, and so is MLA (the reference asserts)."""
    config = model.config
    if config.is_gptoss or config.is_mla:
        family = "gpt-oss" if config.is_gptoss else "MLA"
        raise NotImplementedError(
            f"{config.name}: {family} decodes through the unified forward; "
            "it has no deferred-write path")
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    x = model.embed[tokens]  # [B, T, H]
    ks, vs = [], []
    for layer_idx, lp in enumerate(model.layers):
        ll = _layer_pack(lora, layer_idx)
        h = rms_norm(x, lp["attn_norm"], config.rms_eps)
        q, k, v = _qkv(h, lp, config, cos, sin, matmul_fn, ll, lora_idx)
        attn = attn_fn(q, kv_cache, layer_idx, block_tables, kv_lens, k, v)
        ks.append(k)
        vs.append(v)
        x = x + _attn_out(attn, lp, matmul_fn, ll, lora_idx)
        x = x + _mlp(x, lp, config, matmul_fn, ll, lora_idx)
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
    lora: Optional[LoraPack] = None,  # init_lora_pack()
    lora_idx: Optional[torch.Tensor] = None,  # [B] adapter slot per row
) -> torch.Tensor:
    """Single-token decode with DEFERRED cache writes: every layer attends
    over (pool history + current-token K/V held in registers); the pool is
    written once at the end for all layers, in place. Returns logits
    [B, 1, V] f32. `decode_attention_fn` (q, kv, layer, tables, lens, k, v)
    overrides the plain history attention (the CUDA flash-decode kernel);
    `matmul_fn` overrides `quant_matmul` for quantized leaves; `lora` and
    `lora_idx` add each row's adapter deltas."""
    return _forward_deferred(
        model, tokens[:, None], positions[:, None], kv_cache, block_tables,
        kv_lens, active, decode_attention_fn or paged_attention_decode_xla,
        matmul_fn, lora, lora_idx)


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
    lora: Optional[LoraPack] = None,
    lora_idx: Optional[torch.Tensor] = None,
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
        spec_attention_fn or paged_attention_spec_xla, matmul_fn, lora,
        lora_idx)


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
    lora: Optional[LoraPack] = None,  # init_lora_pack()
    lora_idx: Optional[torch.Tensor] = None,  # [B] adapter slot per row
) -> torch.Tensor:
    """Unified chunk forward (prefill T > 1 or decode T = 1): each layer
    writes its K/V into the pool, then attends over the pool. Returns logits
    [B, T, V] f32, or with `last_idx` the rows x[b, last_idx[b]] only,
    [B, 1, V]: the final norm and the head then run on the sampled rows
    alone (each row's values are the full logits' row). `lora` and
    `lora_idx` add each row's adapter deltas (MLA's `wq` one as
    `q_extra`)."""
    config = model.config
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    attention = attention_fn or paged_attention_xla
    # gpt-oss's and MLA's branches ignore attention_fn, as the reference's
    if config.is_gptoss:
        cos, sin = rope_gptoss_tables(positions, config)
    else:
        rotated = (config.mla_rope_head_dim if config.is_mla
                   else config.head_dim)
        cos, sin = rope_tables(positions, rotated, config.rope_theta)
    x = model.embed[tokens]  # [B, T, H]
    for layer_idx, lp in enumerate(model.layers):
        ll = _layer_pack(lora, layer_idx)
        h = rms_norm(x, lp["attn_norm"], config.rms_eps)
        if config.is_mla:
            attn = mla_attention_xla(
                h, lp, config, kv_cache, layer_idx, block_tables, positions,
                kv_lens, valid, (cos, sin),
                q_extra=(_lora_delta(h, ll["wq"], lora_idx)
                         if "wq" in ll else None))
        else:
            q, k, v = _qkv(h, lp, config, cos, sin, matmul_fn, ll, lora_idx)
            write_kv_pages(kv_cache, layer_idx, k, v, block_tables,
                           positions, valid)
            if config.is_gptoss:
                attn = paged_attention_sinks_xla(
                    q, kv_cache, layer_idx, block_tables, positions, kv_lens,
                    lp["sinks"], config.layer_sliding_window(layer_idx))
            else:
                attn = attention(q, kv_cache, layer_idx, block_tables,
                                 positions, kv_lens)
        x = x + _attn_out(attn, lp, matmul_fn, ll, lora_idx)
        x = x + _mlp(x, lp, config, matmul_fn, ll, lora_idx)
    if last_idx is not None:
        x = torch.gather(x, 1, last_idx.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    return _logits(model, x, matmul_fn)


def forward_embed(
    model: Transformer,
    tokens: torch.Tensor,  # [B, T]
    valid: torch.Tensor,  # [B, T] bool
    matmul_fn: Optional[MatmulFn] = None,
) -> torch.Tensor:
    """Trunk-only forward for embedding requests: in-chunk causal attention
    masked by `valid` (no KV cache touched), masked mean pooling over the
    valid positions after the final norm, L2 normalization. Returns [B, H]
    f32. Plain PyTorch as the reference's `forward_embed` is plain XLA
    (dense [B, kh, g, T, T] scores, one layer at a time; padded keys take
    -1e30 before the f32 softmax); quantized projections go through
    `matmul_fn` (default `quant_matmul`, the dequant-GEMM kernels on the
    card), and a layer holding a router runs the capacity-dispatched MoE.
    MLA is refused as the reference asserts; gpt-oss is refused too: the
    reference's loop has no sinks, biases, window or gpt-oss experts and
    fails on its layers."""
    config = model.config
    if config.is_mla:
        raise ValueError("embedding path supports standard-attention models")
    if config.is_gptoss:
        raise ValueError(
            f"{config.name}: embeddings of gpt-oss models are not supported "
            "(the embedding trunk has no sink attention, sliding window, "
            "projection biases or gpt-oss experts)")
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    causal = torch.ones((t, t), dtype=torch.bool,
                        device=tokens.device).tril()
    mask = (causal[None, :, :] & valid[:, None, :])[:, None, None]
    group = config.n_q_heads // config.n_kv_heads
    scale = 1.0 / math.sqrt(config.head_dim)
    x = model.embed[tokens]  # [B, T, H]
    for lp in model.layers:
        h = rms_norm(x, lp["attn_norm"], config.rms_eps)
        q, k, v = _qkv(h, lp, config, cos, sin, matmul_fn)
        qg = q.reshape(b, t, config.n_kv_heads, group, config.head_dim)
        scores = torch.einsum("btkgd,bskd->bkgts", qg, k) * scale
        scores = scores.masked_fill(~mask, -1e30)
        weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        del scores
        attn = torch.einsum("bkgts,bskd->btkgd", weights, v)
        del weights
        attn = attn.reshape(b, t, config.n_q_heads, config.head_dim)
        x = x + _attn_out(attn, lp, matmul_fn)
        x = x + _mlp(x, lp, config, matmul_fn)
    x = rms_norm(x, model.final_norm, config.rms_eps).float()
    w = valid.float()[:, :, None]
    pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
    return pooled / torch.linalg.vector_norm(
        pooled, dim=-1, keepdim=True).clamp(min=1e-9)
