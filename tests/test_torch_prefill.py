"""Prefill as the reference runs it (`ModelRunner.prefill_chunk`,
`prefill_chunk_batch`, the scheduler's batched prefill) against the JAX
package, on tiny-test in float32 on the CPU, the JAX params carried across
by `params_from_numpy`.

Tolerances, as test_torch_transformer.py holds them: logprobs and the
written pool 1e-5 (the f32 summation order of XLA's and PyTorch's CPU
kernels differs in the last bits); greedy tokens and top ids equal. A row's
result under another grouping is held to the same 1e-5, since the GEMMs
then run at another M; its token is equal, as the sampler keys on
(seed, step) and never on the row. Page 0 is the scratch page padding
writes to, so pools are compared from page 1.

Inputs from numpy seeds; no processes, no sockets.
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
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import InferenceScheduler, ModelRunner, RunnerConfig
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import forward, make_kv_cache, params_from_numpy
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.ops._launch import count_launch

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=64, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
P = RUNNER["max_pages_per_seq"]
TOL = 1e-5
GREEDY = (0.0, 1.0, 0, 0)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _runner(params, **overrides):
    return ModelRunner(CFG, RunnerConfig(**{**RUNNER, **overrides}),
                       device="cpu",
                       params=params_from_numpy(params, CFG, device="cpu"))


def _j_runner(params):
    return JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                   params=params)


def _table(first: int) -> np.ndarray:
    """A sequence's block table: pages first, first + 1, ... (page 0 never)."""
    return np.arange(first, first + P, dtype=np.int32)


def _pools_close(runner, j_runner):
    pool = runner.kv_cache.numpy()[:, :, 1:]
    j_pool = np.asarray(jnp.asarray(j_runner.kv_cache, jnp.float32))[:, :, 1:]
    np.testing.assert_array_equal(pool != 0, j_pool != 0)
    np.testing.assert_allclose(pool, j_pool, rtol=TOL, atol=TOL)


def _samples_close(got, want):
    """(logprob, top ids, top logprobs) of one row."""
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=TOL, atol=TOL)


def test_prefill_chunk_matches_the_jax_runner(params):
    """Two chunks of one sequence (5 tokens, then 11 over them: buckets 8
    and 16) and a one-token chunk of another, each padded to its bucket:
    the same greedy token, logprob data and pool as the JAX runner's."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, CFG.vocab_size, 16)
    chunks = [(prompt[:5], 0, _table(1), 5),
              (prompt[5:], 5, _table(1), 16),
              (rng.integers(1, CFG.vocab_size, 1), 0, _table(20), 1)]
    runner, j_runner = _runner(params), _j_runner(params)
    for tokens, start, table, kv_after in chunks:
        got = runner.prefill_chunk(tokens, start, table, kv_after, GREEDY)
        want = j_runner.prefill_chunk(tokens.astype(np.int32), start, table,
                                      kv_after, GREEDY)
        assert got == want
        _samples_close(runner.last_prefill_sample,
                       j_runner.last_prefill_sample)
    _pools_close(runner, j_runner)
    assert runner.prefill_steps == 3
    assert {key[:4] for key in runner.step_graphs} == {
        ("prefill", 1, P, 8), ("prefill", 1, P, 16)}


def _batch_rows(rng, lengths, firsts, temps):
    return [(rng.integers(1, CFG.vocab_size, n), 0, _table(first), n,
             (temp, 1.0, 0, 7 + i))
            for i, (n, first, temp) in enumerate(zip(lengths, firsts, temps))]


def test_prefill_chunk_batch_matches_the_jax_runner(params):
    """Three sequences' chunks (3, 7 and 6 tokens) in one dispatch: B padded
    to 4, bucket 8. Tokens, per-row samples and the pool equal the JAX
    runner's prefill_chunk_batch."""
    rows = _batch_rows(np.random.default_rng(2), [3, 7, 6], [1, 20, 40],
                       [0.0, 0.0, 0.0])
    runner, j_runner = _runner(params), _j_runner(params)
    got = runner.prefill_chunk_batch(rows, want_samples=True)
    want = j_runner.prefill_chunk_batch(
        [(t.astype(np.int32), s, tb, kv, samp, 0)
         for t, s, tb, kv, samp in rows], want_samples=True)
    assert tuple(got.shape) == (4,)
    np.testing.assert_array_equal(got.numpy()[:3], np.asarray(want)[:3])
    for mine, theirs in zip(runner.last_prefill_samples,
                            j_runner.last_prefill_samples):
        _samples_close(mine, theirs)
    _pools_close(runner, j_runner)
    assert runner.prefill_steps == 1
    assert {key[:4] for key in runner.step_graphs} == {("prefill", 4, P, 8)}


def test_padding_touches_no_page_but_page_0(params):
    """A chunk of 5 (padded to 8; its table of 2 pages padded to 16 with
    page 0) and a batch of three rows (padded to four) write only their own
    tokens' slots and the scratch page."""
    rng = np.random.default_rng(3)
    runner = _runner(params)
    runner.prefill_chunk(rng.integers(1, CFG.vocab_size, 5), 2,
                         _table(30)[:2], 7, GREEDY)
    runner.prefill_chunk_batch(_batch_rows(rng, [3, 7, 6], [1, 10, 44],
                                           [0.0, 0.8, 0.0]))
    written = np.zeros((RUNNER["num_pages"], RUNNER["page_size"]),
                       bool)
    for first, start, n in ((30, 2, 5), (1, 0, 3), (10, 0, 7), (44, 0, 6)):
        for pos in range(start, start + n):
            written[first + pos // 4, pos % 4] = True
    pool = runner.kv_cache.numpy()  # [L, 2, pages, page_size, kh, hd]
    nonzero = (pool != 0).any(axis=(0, 1, 4, 5))
    assert nonzero[0].any()  # padding landed on the scratch page
    np.testing.assert_array_equal(nonzero[1:], written[1:])


def test_forward_last_idx_returns_the_full_logits_rows(params):
    rng = np.random.default_rng(4)
    model = params_from_numpy(params, CFG, device="cpu")
    b, t = 3, 11
    tokens = torch.from_numpy(rng.integers(0, CFG.vocab_size, (b, t)))
    positions = torch.arange(t).repeat(b, 1)
    tables = torch.from_numpy(np.stack([_table(1 + 8 * i)[:8]
                                        for i in range(b)]))
    lens = torch.full((b,), t, dtype=torch.int32)
    last = torch.tensor([10, 4, 0])
    full = forward(model, tokens, positions,
                   make_kv_cache(CFG, 32, 4, device="cpu"), tables, lens)
    rows = forward(model, tokens, positions,
                   make_kv_cache(CFG, 32, 4, device="cpu"), tables, lens,
                   last_idx=last)
    assert tuple(rows.shape) == (b, 1, CFG.vocab_size)
    np.testing.assert_allclose(rows[:, 0].numpy(),
                               full[torch.arange(b), last].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_groups_split_at_the_largest_bucket_and_rows_agree(params):
    """Lengths 20, 5, 7, 3, 30, 2 under a 32-token largest bucket: a group
    grows while its padded batch times its bucket stays within 32. Each
    row's token and samples are the same as one dispatch per row and as
    pairs; greedy and sampled rows alike."""
    lengths = [20, 5, 7, 3, 30, 2]
    rows = _batch_rows(np.random.default_rng(5), lengths,
                       [1 + 9 * i for i in range(6)],
                       [0.0, 0.8, 0.0, 0.8, 0.8, 0.0])
    runner = _runner(params)
    assert runner.prefill_groups(lengths) == [[0], [1, 2, 3], [4], [5]]
    assert runner.prefill_groups([8] * 4) == [[0, 1, 2, 3]]
    assert runner.prefill_groups([8] * 5) == [[0, 1, 2, 3], [4]]
    whole = runner.prefill_chunk_batch(rows, want_samples=True)
    assert runner.prefill_steps == 4
    assert tuple(whole.shape) == (6,)
    assert {key[:4] for key in runner.step_graphs} == {
        ("prefill", 1, P, 32), ("prefill", 4, P, 8), ("prefill", 1, P, 8)}
    want = list(zip(whole.numpy(), runner.last_prefill_samples))
    for grouping in ([[i] for i in range(6)], [[0, 1], [2, 3], [4, 5]]):
        other = _runner(params)
        got = []
        for g in grouping:
            toks = other.prefill_chunk_batch([rows[i] for i in g],
                                             want_samples=True)
            got += list(zip(toks.numpy(), other.last_prefill_samples))
        for (tok, samples), (want_tok, want_samples) in zip(got, want):
            assert tok == want_tok
            _samples_close(samples, want_samples)


def test_a_device_token_survives_the_next_replay_of_its_key(params):
    """return_device=True hands back a clone: the scheduler's deferred
    final-chunk token keeps its value after the same key replays."""
    rng = np.random.default_rng(6)
    runner = _runner(params)
    first = runner.prefill_chunk(rng.integers(1, CFG.vocab_size, 6), 0,
                                 _table(1), 6, GREEDY, return_device=True)
    value = int(first[0])
    runner.prefill_chunk(rng.integers(1, CFG.vocab_size, 7), 0, _table(20),
                         7, GREEDY, return_device=True)
    assert runner.graph_captures == 1 and runner.graph_replays == 2
    assert int(first[0]) == value


def test_prefill_on_the_unified_runner_launches_no_t1_kernel(params,
                                                            monkeypatch):
    """A one-token prompt on a runner with the reference's unified
    attention: its chunk is padded to 8 tokens, so prefill never reaches
    the T = 1 decode kernel (row 3); the decode step after it does."""
    kernel = tpa.paged_decode_attention
    monkeypatch.setattr(kernel, "launches", 0)

    def counting(*args, **kwargs):
        count_launch(kernel)  # as the kernel counts itself on the card
        return kernel(*args, **kwargs)

    monkeypatch.setattr(tpa, "paged_decode_attention", counting)
    runner = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"),
                         attention_fn=tpa.paged_attention)
    token = runner.prefill_chunk(np.asarray([17]), 0, _table(1), 1, GREEDY)
    assert kernel.launches == 0
    b = RUNNER["max_batch"]
    tables = np.zeros((b, 8), np.int32)
    tables[0] = _table(1)[:8]
    active = np.zeros(b, bool)
    active[0] = True
    runner.decode(np.asarray([token, 0, 0, 0]), np.asarray([1, 0, 0, 0]),
                  tables, np.asarray([2, 0, 0, 0]), active,
                  np.zeros(b, np.float32), np.ones(b, np.float32),
                  np.zeros(b, np.int32), np.zeros(b, np.uint32))
    # the decode key's capture runs one eager forward, then one replay
    assert kernel.launches == 2 * CFG.n_layers


# -- the scheduler's batched prefill ------------------------------------------


PROMPTS = [np.random.default_rng(8).integers(1, CFG.vocab_size, 21).tolist(),
           np.random.default_rng(9).integers(1, CFG.vocab_size, 13).tolist()]
MAX_TOKENS = 8


def _requests(make, sampling, stop, prompts):
    return [make(request_id=f"r-{i}", token_ids=p,
                 sampling=sampling(max_tokens=MAX_TOKENS, temperature=0.0,
                                   seed=i, logprobs=i == 0, top_logprobs=3),
                 stop=stop(ignore_eos=True))
            for i, p in enumerate(prompts)]


def _collect(sched, requests, start_after_submit, timeout=60.0):
    """{rid: (tokens, first frame's logprobs and top_logprobs)}."""
    out = {r.request_id: [] for r in requests}
    done = threading.Event()
    lock = threading.Lock()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].append(o)
                if (o.finish_reason is not None
                        and all(any(x.finish_reason for x in v)
                                for v in out.values())):
                    done.set()
        return emit

    if not start_after_submit:
        sched.start()
    try:
        for r in requests:
            sched.submit(r, emitter(r.request_id))
        if start_after_submit:
            # both admitted in the first iteration: one batched dispatch
            sched.start()
        assert done.wait(timeout), "streams did not finish"
    finally:
        sched.stop()
    return {rid: ([t for o in outs for t in o.token_ids],
                  outs[0].logprobs, outs[0].top_logprobs,
                  [o.finish_reason for o in outs if o.finish_reason])
            for rid, outs in out.items()}


def _assert_streams_close(got, want):
    assert got.keys() == want.keys()
    for rid in got:
        tokens, lps, tops, reasons = got[rid]
        w_tokens, w_lps, w_tops, w_reasons = want[rid]
        assert tokens == w_tokens and reasons == w_reasons == ["length"]
        assert (lps is None) == (w_lps is None)
        if lps is not None:
            np.testing.assert_allclose(lps, w_lps, rtol=TOL, atol=TOL)
            assert [i for i, _ in tops[0]] == [i for i, _ in w_tops[0]]
            np.testing.assert_allclose([v for _, v in tops[0]],
                                       [v for _, v in w_tops[0]],
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
def test_batched_prefill_streams_equal_sequential_and_jax(params, graphs,
                                                          monkeypatch):
    """Two prompts admitted together (one asking for logprobs) prefill in
    one batched dispatch; their streams equal each prompt served alone, the
    JAX scheduler's batched streams, and, graphs on or off, each other."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    requests = _requests(PreprocessedRequest, SamplingOptions,
                         StopConditions, PROMPTS)
    sequential = {}
    for r in requests:
        sched = InferenceScheduler(_runner(params, cuda_graphs=graphs))
        sequential.update(_collect(sched, [r], start_after_submit=False))
        assert sched.stats.prefill_batched_steps == 0
    runner = _runner(params, cuda_graphs=graphs)
    sched = InferenceScheduler(runner)
    batched = _collect(sched, requests, start_after_submit=True)
    assert sched.stats.prefill_batched_steps >= 1
    assert sched.error is None
    j_sched = JScheduler(_j_runner(params))
    reference = _collect(j_sched, _requests(JRequest, JSampling, JStop,
                                            PROMPTS), start_after_submit=True)
    assert j_sched.stats.prefill_batched_steps >= 1
    _assert_streams_close(batched, sequential)
    _assert_streams_close(batched, reference)
    if graphs:
        assert runner.graph_replays > 0
        assert runner.eager_forwards == {"decode": 0, "spec": 0,
                                         "prefill": 0}
    else:
        assert runner.graph_replays == 0
        assert runner.eager_forwards["prefill"] == runner.prefill_steps > 0
