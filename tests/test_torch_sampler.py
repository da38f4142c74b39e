"""The port's sampler (dynamo_tpu_torch.engine.sampler) against the JAX one.

The port draws JAX's threefry Gumbel noise for each (seed, step), so the
comparisons are: the noise against `jax.random.gumbel`, the sampled ids of
`sample`, `sample_with_logprobs` and `spec_verify` equal to JAX's for
temperature, top-k and top-p mixes, greedy bit-equal, the top-k / top-p
support sets equal, (seed, step) -> token independent of the batch,
temperature sampling following softmax(logits / T) (chi-square), and a
TorchWorker's seeded temperature streams equal to the JAX engine's.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.sampler import sample as j_sample
from dynamo_tpu.engine.sampler import sample_with_logprobs as j_sample_lp
from dynamo_tpu.engine.sampler import spec_verify as j_spec_verify
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker, sampler
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.ops.gumbel import gumbel_noise


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


# -- JAX's draw, bit for bit -----------------------------------------------------


def test_noise_equals_jax_gumbel():
    """The noise of each (seed, step) against jax.random.gumbel of
    fold_in(PRNGKey(seed), step): the threefry bits and the uniform are
    exact, and each value is within 2 ulp of max(|x|, 1). The outer log
    takes the inner -log(u), which is near 1 where x is near 0, so the two
    frameworks' log rounding shows there as an absolute error, not a
    relative one."""
    seeds = np.asarray([0, 1, 7, 2**31 + 5, 2**32 - 1, 123456], np.uint32)
    steps = np.asarray([0, 3, 1, 100, 2**20, 7], np.int32)
    vocab = 4099
    got = gumbel_noise(torch.from_numpy(seeds.astype(np.int64)),
                       torch.from_numpy(steps.astype(np.int64)),
                       vocab).numpy()
    for s, t, row in zip(seeds, steps, got):
        key = jax.random.fold_in(jax.random.PRNGKey(s), t)
        want = np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32))
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert np.all(np.abs(row - want) <= 2 * ulp), (s, t)
        assert np.isfinite(row).all()


def _mix(b, rng):
    """Temperature, top-p, top-k, seeds and steps for b slots: greedy,
    plain temperature, top-k, top-p and both, in turn."""
    kinds = [(0.0, 1.0, 0), (0.8, 1.0, 0), (1.0, 1.0, 5), (0.7, 0.9, 0),
             (1.3, 0.8, 12)]
    temp, top_p, top_k = (np.asarray([kinds[i % len(kinds)][j]
                                      for i in range(b)], dt)
                          for j, dt in enumerate((np.float32, np.float32,
                                                  np.int32)))
    seeds = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    steps = rng.integers(0, 5000, b).astype(np.int32)
    return temp, top_p, top_k, seeds, steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_ids_equal_jax(seed):
    rng = np.random.default_rng(seed)
    b, v, t = 10, 700, 4
    logits = rng.normal(scale=2.0, size=(b, t, v)).astype(np.float32)
    temp, top_p, top_k, seeds, steps = _mix(b, rng)
    drafts = rng.integers(0, v, (b, t - 1)).astype(np.int32)
    j_args = [jnp.asarray(a) for a in (temp, top_p, top_k, seeds)]
    p_args = [torch.from_numpy(temp), torch.from_numpy(top_p),
              torch.from_numpy(top_k),
              torch.from_numpy(seeds.astype(np.int64))]
    p_steps = torch.from_numpy(steps.astype(np.int64))
    row0 = logits[:, 0]
    want = np.asarray(j_sample(jnp.asarray(row0), *j_args,
                               jnp.asarray(steps)))
    got = sampler.sample(torch.from_numpy(row0), *p_args, p_steps).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 3  # the draws are not all greedy ties
    j_lp = j_sample_lp(jnp.asarray(row0), *j_args, jnp.asarray(steps))
    p_lp = sampler.sample_with_logprobs(torch.from_numpy(row0), *p_args,
                                        p_steps)
    np.testing.assert_array_equal(p_lp[0].numpy(), np.asarray(j_lp[0]))
    np.testing.assert_array_equal(p_lp[2].numpy(), np.asarray(j_lp[2]))
    # a draft that equals the target at position 0 makes acceptance move
    drafts[::2, 0] = want[::2]
    j_targets, j_acc = j_spec_verify(jnp.asarray(logits),
                                     jnp.asarray(drafts), *j_args,
                                     jnp.asarray(steps))
    targets, acc = sampler.spec_verify(torch.from_numpy(logits),
                                       torch.from_numpy(drafts), *p_args,
                                       p_steps)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(j_targets))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    assert acc.numpy().max() >= 1


# -- seeded temperature streams of the two engines --------------------------------

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=256, max_batch=4, max_pages_per_seq=32,
              prefill_buckets=(8, 16, 32))


def _serve(scheduler, requests, n):
    out = {rid: [] for rid, _ in requests}
    done = threading.Event()
    lock = threading.Lock()
    finished = set()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].extend(o.token_ids)
                if o.finish_reason is not None:
                    finished.add(rid)
                    if len(finished) == n:
                        done.set()
        return emit

    scheduler.start()
    try:
        for rid, req in requests:
            scheduler.submit(req, emitter(rid))
        assert done.wait(60.0), "streams did not finish"
    finally:
        scheduler.stop()
    return out


@pytest.mark.parametrize("spec", [False, True])
def test_seeded_temperature_streams_equal_jax_engine(spec, monkeypatch):
    """Four requests, each sampled at temperature 0.8 (two with top-k or
    top-p) from its own seed, through a TorchWorker and through the JAX
    engine on the same tiny-test weights: the streams are equal token for
    token, with speculation off and on."""
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1" if spec else "0")
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    params = jax.device_get(j_init(jax.random.PRNGKey(3), CFG))
    rng = np.random.default_rng(11)
    loop = [5, 9, 2, 5, 9, 2, 5, 9, 2]
    prompts = [loop, rng.integers(1, CFG.vocab_size, 13).tolist(),
               list(range(1, 30)), loop * 2]
    knobs = [(1.0, 0), (1.0, 8), (0.9, 0), (1.0, 0)]
    n = 24

    def requests(make_req, make_samp, make_stop):
        return [(f"r{i}", make_req(
            request_id=f"r{i}", token_ids=p,
            sampling=make_samp(max_tokens=n, temperature=0.8, top_p=tp,
                               top_k=tk, seed=100 + i),
            stop=make_stop(ignore_eos=True)))
            for i, (p, (tp, tk)) in enumerate(zip(prompts, knobs))]

    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    assert worker.scheduler.spec_enabled == spec
    got = _serve(worker.scheduler, requests(
        PreprocessedRequest, SamplingOptions, StopConditions), len(prompts))
    j_runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                       params=params)
    want = _serve(JScheduler(j_runner), requests(JRequest, JSampling, JStop),
                  len(prompts))
    assert all(len(t) == n for t in got.values())
    assert got == want
