"""Routed experts: top-k routing, the capacity dispatch and the combine.

Port of `_routing_weights`, `_shared_expert`, `_moe_dense` and `_moe` in
`dynamo_tpu/models/transformer.py`. A MoE layer's leaves, in the JAX
package's layouts: `router [h, e]`, `e_gate / e_up [e, h, em]`,
`e_down [e, em, h]`, `e_bias [e]` (f32, sigmoid scoring only) and, with
shared experts, `s_gate / s_up [h, sm]`, `s_down [sm, h]`.

`moe` computes what the reference's capacity dispatch computes, without its
one-hot tensors:

  * capacity is per batch row: `cap = max(k, ceil(cf * t * k / e))` slots
    per expert for a chunk of `t` tokens (the padded length: padding tokens
    route and take slots like any other);
  * picks are ranked k-major (every token's first choice, then every second
    choice, ...), and a pick ranked past `cap` in its expert is dropped;
  * the slot of each pick is an exclusive cumulative count over the row's
    k-major picks, so the kept picks are scattered straight into an
    [e, b, cap', h] buffer (dropped picks into one scratch row that is
    discarded), where `cap' = min(cap, t)`: top-k picks are distinct, so a
    row puts at most t tokens into an expert and the slots past t would stay
    empty;
  * the three expert projections run as `torch.bmm` over the expert axis
    (the reference computes them as plain einsums, outside any kernel),
    and silu runs op by op as the reference's `jax.nn.silu` is written
    (x * (1 / (1 + exp(-x))), each op rounding in the model dtype), so a
    bf16 expert rounds where the reference's does;
  * each token's k outputs are gathered back and summed in f32 with the
    routing weights rounded to the model dtype first, as the reference's
    `combine.astype(x.dtype)` rounds them, then rounded once.

Top-k selections sort stably in descending order, so equal scores keep the
lower expert first, as `jax.lax.top_k` orders them: the order of the k picks
decides who wins a slot. Every shape is static and nothing reads back to
the host, so a step that runs `moe` is one CUDA-graph replay.

`moe_gptoss` is the port of `_moe_gptoss`, gpt-oss's block: a biased f32
router, a softmax over the top-k logits, and every expert on every token
(dense over experts, no capacity, nothing dropped) with the fused,
interleaved gate/up projection and the clipped gated SwiGLU; the top-k mask
combines the experts' outputs in f32. It never goes through the capacity
dispatch. Its leaves: `router [h, e]`, `router_bias [e]`,
`e_gate_up [e, h, 2em]` (gate at the even columns, up at the odd ones),
`e_gate_up_bias [e, 2em]`, `e_down [e, em, h]`, `e_down_bias [e, h]`.
"""

from __future__ import annotations

import math

import torch

from .config import ModelConfig


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, largest
    first, ties to the lower index (`jax.lax.top_k`'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def routing_weights(x: torch.Tensor, p, config: ModelConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of x [b, t, h]: router logits in f32; softmax over all
    experts, or (DeepSeek-V3) sigmoid scores whose selection adds `e_bias`
    and keeps the `moe_topk_group` best of `moe_n_group` groups (each group
    scored by its two best); weights are the unbiased scores at the picks,
    renormalized over the k with `moe_norm_topk`, times `moe_routed_scale`.
    Returns (weights [b, t, k] f32, expert indices [b, t, k] int64)."""
    logits = x.float() @ p["router"].float()  # [b, t, e]
    k = config.n_experts_active
    if config.moe_scoring == "sigmoid":
        b, t, e = logits.shape
        scores = torch.sigmoid(logits)
        choice = scores + p["e_bias"].float()
        g = config.moe_n_group
        if g > 1:
            grouped = choice.reshape(b, t, g, e // g)
            group_scores = _top_k(grouped, 2)[0].sum(-1)  # [b, t, g]
            gidx = _top_k(group_scores, config.moe_topk_group)[1]
            gmask = torch.zeros_like(group_scores).scatter(-1, gidx, 1.0)
            choice = torch.where(
                gmask.repeat_interleave(e // g, dim=-1) > 0, choice, 0.0)
        topi = _top_k(choice, k)[1]
        topv = torch.gather(scores, -1, topi)
    else:
        topv, topi = _top_k(torch.softmax(logits, dim=-1), k)
    if config.moe_norm_topk:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
    return topv * config.moe_routed_scale, topi


def pick_slots(topi: torch.Tensor, n_experts: int, cap: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The capacity slot of every pick of topi [b, t, k], as the reference's
    exclusive cumsum over each row's k-major picks gives it. Returns (slot,
    keep), both [b, k, t] (k-major): keep is slot < cap."""
    b, t, k = topi.shape
    sel = topi.transpose(1, 2).reshape(b, k * t)  # all 1st picks, 2nd, ...
    experts = torch.arange(n_experts, device=topi.device)
    # expert-major [b, e, k*t], so the count runs along the innermost axis
    # (CUDA's scan along an outer axis runs the k*t picks one after another)
    onehot = (sel[:, None, :] == experts[:, None]).to(torch.int32)
    before = onehot.cumsum(-1, dtype=torch.int32) - onehot
    slot = before.gather(1, sel[:, None, :])[:, 0].view(b, k, t)
    return slot, slot < cap


def _silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` op by op: in bf16 every op rounds, as there."""
    return x * (1 / (1 + torch.exp(-x)))


def shared_expert(x: torch.Tensor, p) -> torch.Tensor:
    """The always-active shared-expert SwiGLU (DeepSeek n_shared_experts)."""
    return (_silu(x @ p["s_gate"]) * (x @ p["s_up"])) @ p["s_down"]


def moe_dense(x: torch.Tensor, p, config: ModelConfig) -> torch.Tensor:
    """The oracle: every expert on every token, weighted by the router's
    top-k mask (no capacity, nothing dropped). The tests hold `moe` to it;
    nothing on a serving path calls it."""
    b, t, _ = x.shape
    weights, topi = routing_weights(x, p, config)
    mask = torch.zeros((b, t, config.n_experts), dtype=torch.float32,
                       device=x.device).scatter(-1, topi, weights)
    gate = torch.einsum("bth,ehm->betm", x, p["e_gate"])
    up = torch.einsum("bth,ehm->betm", x, p["e_up"])
    expert_out = torch.einsum("betm,emh->beth", _silu(gate) * up,
                              p["e_down"])
    out = torch.einsum("beth,bte->bth", expert_out, mask.to(x.dtype))
    if "s_gate" in p:
        out = out + shared_expert(x, p)
    return out


def capacity(config: ModelConfig, t: int) -> int:
    """Slots per expert for a chunk of t (padded) tokens in one row."""
    k = config.n_experts_active
    return max(k, int(math.ceil(config.moe_capacity_factor * t * k
                                / config.n_experts)))


def moe(x: torch.Tensor, p, config: ModelConfig) -> torch.Tensor:
    """The capacity-dispatched MoE block for x [b, t, h] (the reference's
    `_moe`); returns [b, t, h] in x's dtype."""
    b, t, h = x.shape
    e, k = config.n_experts, config.n_experts_active
    weights, topi = routing_weights(x, p, config)
    slot, keep = pick_slots(topi, e, capacity(config, t))
    cap = min(capacity(config, t), t)  # the slots that can hold a pick
    rows = e * b * cap
    # Each kept pick's row in the [e, b, cap] buffer; dropped picks all go
    # to row `rows`, past the buffer, which nothing reads.
    row_of = torch.arange(b, device=x.device).view(b, 1, 1)
    dest = torch.where(keep, (topi.transpose(1, 2) * b + row_of) * cap + slot,
                       rows).reshape(-1)
    xe = x.new_zeros(rows + 1, h)
    xe.index_copy_(0, dest, x[:, None].expand(b, k, t, h).reshape(-1, h))
    xe = xe[:rows].view(e, b * cap, h)
    act = _silu(torch.bmm(xe, p["e_gate"])) * torch.bmm(xe, p["e_up"])
    out_e = torch.bmm(act, p["e_down"]).view(rows, h)
    out_e = torch.cat([out_e, out_e.new_zeros(1, h)])
    picked = out_e[dest].view(b, k, t, h)
    w = torch.where(keep, weights.transpose(1, 2).to(x.dtype), 0)
    out = (w.float()[..., None] * picked.float()).sum(1).to(x.dtype)
    if "s_gate" in p:
        out = out + shared_expert(x, p)
    return out


def moe_gptoss(x: torch.Tensor, p, config: ModelConfig) -> torch.Tensor:
    """gpt-oss's MoE block for x [b, t, h] (the reference's `_moe_gptoss`);
    returns [b, t, h] in x's dtype. The expert projections run as batched
    matmuls over the expert axis, every token through every expert."""
    b, t, h = x.shape
    e, k = config.n_experts, config.n_experts_active
    logits = x.float() @ p["router"].float() + p["router_bias"].float()
    topv, topi = _top_k(logits.reshape(b * t, e), k)
    mask = torch.zeros((b * t, e), dtype=torch.float32,
                       device=x.device).scatter(-1, topi,
                                                torch.softmax(topv, dim=-1))
    xs = x.reshape(1, b * t, h).expand(e, b * t, h)
    gate_up = (torch.bmm(xs, p["e_gate_up"])
               + p["e_gate_up_bias"][:, None, :].to(x.dtype))  # [e, bt, 2em]
    limit = config.swiglu_limit
    gate = gate_up[..., ::2].float().clamp(max=limit)
    up = gate_up[..., 1::2].float().clamp(min=-limit, max=limit)
    glu = gate * torch.sigmoid(gate * config.swiglu_alpha)
    act = ((up + 1.0) * glu).to(x.dtype)
    expert_out = (torch.bmm(act, p["e_down"])
                  + p["e_down_bias"][:, None, :].to(x.dtype))  # [e, bt, h]
    out = (expert_out.float() * mask.t()[:, :, None]).sum(0)
    return out.to(x.dtype).reshape(b, t, h)
