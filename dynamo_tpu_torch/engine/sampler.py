"""Batched sampling on the device.

Port of `dynamo_tpu/engine/sampler.py` (`sample`, `sample_with_logprobs`,
`spec_verify`). Only the sampled ids [B] need to cross to the host. Every
slot carries temperature / top-k / top-p; greedy is temperature == 0 and is
bit-exact `argmax`. The truncation masks are the JAX package's, expression for
expression.

Randomness: the contract is (seed, step) -> token, independent of whatever
else is in the batch. As in JAX, each slot's key is
`fold_in(PRNGKey(seed), step)` and its Gumbel noise JAX's threefry draw
(`ops.gumbel.gumbel_noise`: a fused Triton pass on the card, int64 tensor
ops on the CPU), so no global generator is involved, a row's draw never
depends on its neighbours, and the two frameworks sample the same token for
the same logits, seed and step.

The JAX sampler skips the truncation sort and the noise at run time when no
slot needs them (`lax.cond`). Deciding that here would cost a host sync per
step, so both are always computed and `where` selects: the tokens are the
same as with the gate.
"""

from __future__ import annotations

import torch

from ..ops.gumbel import gumbel_noise

# Top alternatives returned with every sampled token.
TOP_LOGPROBS_K = 8


def _truncate(scaled: torch.Tensor, top_p: torch.Tensor,
              top_k: torch.Tensor) -> torch.Tensor:
    v = scaled.shape[-1]
    # top-k: mask logits below the k-th largest (k = 0 -> disabled)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (top_k.long() - 1).clamp(0, v - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    topk_mask = (scaled >= kth) | (top_k[:, None] <= 0)
    # top-p: smallest set of tokens with cumulative prob >= top_p
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cumprobs = torch.cumsum(probs_sorted, dim=-1)
    # a token is kept if its sorted-cumulative position (exclusive) < top_p
    cutoff = cumprobs - probs_sorted < top_p[:, None]
    # map back: a logit is kept if >= the smallest kept sorted logit
    min_kept = torch.where(cutoff, sorted_desc,
                           torch.full_like(sorted_desc, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    topp_mask = (scaled >= min_kept) | (top_p[:, None] >= 1.0)
    return torch.where(topk_mask & topp_mask, scaled,
                       torch.full_like(scaled, float("-inf")))


def sample(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,  # [B] f32
    top_p: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int (0 = disabled)
    seeds: torch.Tensor,  # [B] int, u32 range
    step,  # [B] int tensor or int: per-slot generated-token index
) -> torch.Tensor:
    """Returns sampled token ids [B] int32."""
    b, v = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    masked = _truncate(logits / safe_t[:, None], top_p, top_k)
    steps = torch.as_tensor(step, device=logits.device).long().expand(b)
    sampled = torch.argmax(masked + gumbel_noise(seeds, steps, v), dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def sample_with_logprobs(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    seeds: torch.Tensor,
    step,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """sample() plus logprob data from the RAW model distribution.
    Returns (tokens [B], logprob [B], top_ids [B, K], top_logprobs [B, K])."""
    tokens = sample(logits, temperature, top_p, top_k, seeds, step)
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_lp = torch.gather(logp, 1, tokens.long()[:, None])[:, 0]
    k = min(TOP_LOGPROBS_K, logits.shape[-1])
    top_lps, top_ids = torch.topk(logp, k, dim=-1)
    return tokens, token_lp, top_ids.to(torch.int32), top_lps


def spec_verify(
    logits: torch.Tensor,  # [B, T, V] f32: rows for T chunk positions
    drafts: torch.Tensor,  # [B, T-1] int: proposed continuation tokens
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    seeds: torch.Tensor,
    step,  # [B] int tensor or int: generated-token index of row 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Verify draftless speculative proposals against the target
    distribution (Leviathan et al., 2023, for a point-mass draft).

    Position i draws the token the non-speculative sampler would emit there:
    `sample()` with the same (seed, step + i) key, so the draw is the one
    sequential decode makes. A draft is accepted iff it equals that target;
    the first mismatch emits the target itself (for a point-mass draft that
    is exactly the residual distribution), and a fully accepted draft emits
    the bonus target of row T-1. The committed tokens are therefore the
    stream the per-token path samples for a fixed seed, greedy and
    temperature alike.

    Returns (targets [B, T] int32, n_accept [B]); callers commit
    targets[:, : n_accept + 1]."""
    b, t, _ = logits.shape
    steps = torch.as_tensor(step, device=logits.device).long().expand(b)
    targets = torch.stack(
        [sample(logits[:, i, :], temperature, top_p, top_k, seeds, steps + i)
         for i in range(t)], dim=1)  # [B, T]
    match = (targets[:, :-1] == drafts).to(torch.int32)
    # leading-match count: cumprod zeroes everything after the first mismatch
    n_accept = torch.cumprod(match, dim=1).sum(dim=1)
    return targets, n_accept
