"""The port's sampler (dynamo_tpu_torch.engine.sampler) against the JAX one.

The two frameworks draw different random numbers for the same seed, so the
comparisons are: greedy bit-equal, the top-k / top-p support sets equal,
(seed, step) -> token independent of the batch, and temperature sampling
following softmax(logits / T) (chi-square).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.sampler import sample as j_sample
from dynamo_tpu.engine.sampler import sample_with_logprobs as j_sample_lp
from dynamo_tpu_torch.engine import sampler


def _params(b, temp, top_p=1.0, top_k=0, seed=0):
    return (np.full(b, temp, np.float32), np.full(b, top_p, np.float32),
            np.full(b, top_k, np.int32), np.full(b, seed, np.uint32))


def _port(logits, temp, top_p, top_k, seeds, steps):
    return sampler.sample(torch.from_numpy(logits), torch.from_numpy(temp),
                          torch.from_numpy(top_p), torch.from_numpy(top_k),
                          torch.from_numpy(seeds.astype(np.int64)),
                          torch.from_numpy(np.asarray(steps, np.int64))).numpy()


def test_greedy_equals_jax():
    logits = np.random.default_rng(0).normal(size=(6, 1000)).astype(np.float32)
    logits[2, 10] = logits[2, 20] = 50.0  # a tie: both take the first index
    temp, top_p, top_k, seeds = _params(6, 0.0, top_p=0.5, top_k=3)
    steps = np.arange(6, dtype=np.int32)
    want = np.asarray(j_sample(jnp.asarray(logits), jnp.asarray(temp),
                               jnp.asarray(top_p), jnp.asarray(top_k),
                               jnp.asarray(seeds), jnp.asarray(steps)))
    np.testing.assert_array_equal(_port(logits, temp, top_p, top_k, seeds,
                                        steps), want)


@pytest.mark.parametrize("top_p,top_k", [(0.7, 0), (1.0, 5), (0.6, 4),
                                         (0.95, 12)])
def test_truncation_support_matches_jax(top_p, top_k):
    """The set of tokens each sampler can emit: 3000 JAX draws over a flat
    32-token row hit every supported token (each has >= 1.5% mass)."""
    rng = np.random.default_rng(1)
    row = rng.normal(scale=0.6, size=32).astype(np.float32)
    n = 3000
    logits = np.tile(row, (n, 1))
    temp, tp, tk, seeds = _params(n, 1.0, top_p, top_k, seed=9)
    steps = np.arange(n, dtype=np.int32)
    j_draws = np.asarray(j_sample(jnp.asarray(logits), jnp.asarray(temp),
                                  jnp.asarray(tp), jnp.asarray(tk),
                                  jnp.asarray(seeds), jnp.asarray(steps)))
    support = torch.isfinite(sampler._truncate(
        torch.from_numpy(row[None]), torch.tensor([top_p]),
        torch.tensor([top_k])))[0].numpy()
    assert set(np.flatnonzero(support)) == set(j_draws.tolist())
    p_draws = _port(logits, temp, tp, tk, seeds, steps)
    assert set(p_draws.tolist()) <= set(np.flatnonzero(support))


def test_seed_step_token_independent_of_batch():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 300)).astype(np.float32)
    temp, top_p, top_k, _ = _params(5, 0.9, top_p=0.9)
    seeds = np.asarray([3, 3, 7, 2**32 - 1, 0], np.uint32)
    steps = np.asarray([0, 1, 5, 9, 2])
    full = _port(logits, temp, top_p, top_k, seeds, steps)
    # each row alone, and inside a shuffled batch with other rows
    for i in range(5):
        alone = _port(logits[i:i + 1], temp[:1], top_p[:1], top_k[:1],
                      seeds[i:i + 1], steps[i:i + 1])
        assert alone[0] == full[i]
    perm = np.asarray([4, 2, 0, 3, 1])
    shuffled = _port(logits[perm], temp, top_p, top_k, seeds[perm],
                     steps[perm])
    np.testing.assert_array_equal(shuffled, full[perm])
    # a different step or seed draws afresh
    again = _port(np.tile(logits[2], (64, 1)), *_params(64, 0.9)[:3],
                  np.full(64, 7, np.uint32), np.arange(64))
    assert len(set(again.tolist())) > 10


def test_temperature_sampling_follows_softmax():
    """Chi-square of 20000 draws of one 8-token row at T = 0.7 against
    softmax(logits / T): 7 degrees of freedom, bound 30 (p ~ 1e-4)."""
    row = np.asarray([1.0, 0.5, 0.0, -0.5, 2.0, 1.5, -1.0, 0.2], np.float32)
    n = 20000
    temp, top_p, top_k, seeds = _params(n, 0.7, seed=1234)
    draws = _port(np.tile(row, (n, 1)), temp, top_p, top_k, seeds,
                  np.arange(n))
    counts = np.bincount(draws, minlength=8)
    p = np.exp(row / 0.7 - np.max(row / 0.7))
    expected = n * p / p.sum()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 30.0, (chi2, counts, expected)


def test_logprobs_match_jax():
    logits = np.random.default_rng(4).normal(size=(3, 50)).astype(np.float32)
    args = _params(3, 0.0)
    steps = np.zeros(3, np.int32)
    j_tok, j_lp, j_ids, j_lps = j_sample_lp(
        jnp.asarray(logits), *(jnp.asarray(a) for a in args),
        jnp.asarray(steps))
    tok, lp, ids, lps = sampler.sample_with_logprobs(
        torch.from_numpy(logits), torch.from_numpy(args[0]),
        torch.from_numpy(args[1]), torch.from_numpy(args[2]),
        torch.from_numpy(args[3].astype(np.int64)), 0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5)
    np.testing.assert_allclose(lps.numpy(), np.asarray(j_lps), atol=1e-5)
