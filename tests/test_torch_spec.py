"""Speculative decoding in the port (engine/spec.py, sampler.spec_verify,
models.forward_spec, ModelRunner.decode_spec, the scheduler's spec step)
against the JAX package, on tiny-test in float32 on the CPU.

The invariant, as in the reference's tests/test_spec_decode.py: for a fixed
request seed the speculative engine emits the token stream the per-token
path emits, greedy and temperature, because verification commits only the
prefix that matches the target sampler's own draws. Checked here: the
proposers give the JAX package's proposals on the same token streams;
`spec_verify`'s targets are the port's sequential `sample` draws;
`forward_spec`'s logits match JAX's (1e-4 in f32: the two frameworks' f32
matmul summation orders, as test_torch_transformer.py); engine streams are
equal with speculation on and off, and the greedy spec stream equals the
JAX engine's; the two verification attentions' plain versions match the
JAX Pallas spec kernels in interpret mode. Small shapes: each test runs in
seconds.
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
from dynamo_tpu.engine import spec as jspec
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import make_kv_cache as j_make_kv
from dynamo_tpu.models.transformer import forward as j_forward
from dynamo_tpu.models.transformer import forward_spec as j_forward_spec
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu_torch import config as tconfig
from dynamo_tpu_torch.engine import (
    InferenceScheduler,
    ModelRunner,
    RunnerConfig,
    sampler,
)
from dynamo_tpu_torch.engine import spec as tspec
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import (
    forward_decode,
    forward_spec,
    kv_cache_from_numpy,
    params_from_numpy,
)
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.tokens import TokenBlockSequence
from jax_capabilities import requires_pallas_compiler_params

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=256, max_batch=4, max_pages_per_seq=32,
              prefill_buckets=(8, 16, 32))
REPETITIVE = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3]


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def runner(params):
    """One port runner for every engine test: schedulers run one at a time,
    each with a fresh page pool, and prefill rewrites reused pages before
    anything attends them."""
    return ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                       params=params_from_numpy(params, CFG, device="cpu"))


# -- knobs and proposers -------------------------------------------------------


@pytest.mark.parametrize("name,raw", [
    ("DYNT_SPEC_ENABLE", None), ("DYNT_SPEC_ENABLE", " Yes"),
    ("DYNT_SPEC_ENABLE", "off"), ("DYNT_SPEC_MAX_K", None),
    ("DYNT_SPEC_MAX_K", "7"), ("DYNT_SPEC_MIN_EMA", None),
    ("DYNT_SPEC_MIN_EMA", "0.25"), ("DYNT_SPEC_BATCH_CUTOFF", None),
    ("DYNT_SPEC_BATCH_CUTOFF", "3")])
def test_spec_knobs_parse_as_the_reference(name, raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert tconfig.env(name) == jconfig.env(name)


def _streams(seed):
    rng = np.random.default_rng(seed)
    loop = rng.integers(0, 9, 6).tolist()
    return [REPETITIVE, loop * 5 + loop[:2], rng.integers(0, 40, 60).tolist(),
            rng.integers(0, 4, 30).tolist(), [7], []]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_proposals_match_jax(seed):
    for tokens in _streams(seed):
        j_prop, t_prop = jspec.NGramProposer(tokens), tspec.NGramProposer(tokens)
        for k in (0, 1, 3, 4, 9):
            assert t_prop.propose(k) == j_prop.propose(k), (tokens, k)
        # incremental extension indexes the same continuations
        extra = tokens[-3:] + [5, 6]
        j_prop.extend(extra)
        t_prop.extend(extra)
        assert t_prop.tokens == j_prop.tokens
        for k in (1, 4):
            assert t_prop.propose(k) == j_prop.propose(k)


def test_block_lookahead_and_propose_for_match_jax():
    from dynamo_tpu.tokens import TokenBlockSequence as JBlocks

    ps = 4
    rng = np.random.default_rng(3)
    donor = rng.integers(0, 50, 40).tolist()
    j_look, t_look = jspec.BlockLookahead(ps, capacity=6), \
        tspec.BlockLookahead(ps, capacity=6)
    for look, blocks in ((j_look, JBlocks), (t_look, TokenBlockSequence)):
        hasher = blocks(ps)
        hasher.extend(donor)
        look.record(hasher.block_hashes, donor)
    assert len(t_look) == len(j_look) == 6  # LRU-bounded
    for cut in (9, 13, 30, 33):
        live = donor[:cut]
        for k in (2, 4):
            slots = []
            for mod, blocks in ((jspec, JBlocks), (tspec, TokenBlockSequence)):
                hasher = blocks(ps)
                hasher.extend(live)
                slots.append(mod.SlotSpec(
                    proposer=mod.NGramProposer(live),
                    stop_ids=frozenset({donor[cut + 1]}), hasher=hasher))
            j_slot, t_slot = slots
            assert t_slot.hasher.block_hashes == j_slot.hasher.block_hashes
            for remaining in (1, 3, 10):
                assert (tspec.propose_for(t_slot, t_look, k, remaining)
                        == jspec.propose_for(j_slot, j_look, k, remaining))
    slot = tspec.SlotSpec(proposer=tspec.NGramProposer([]),
                          stop_ids=frozenset(), hasher=TokenBlockSequence(ps))
    ref = jspec.SlotSpec(proposer=jspec.NGramProposer([]),
                         stop_ids=frozenset(), hasher=JBlocks(ps))
    for proposed, accepted in ((4, 0), (4, 1), (3, 3), (0, 0), (2, 2)):
        slot.observe(proposed, accepted)
        ref.observe(proposed, accepted)
        assert slot.ema == ref.ema
    assert [slot.wants_probe() for _ in range(32)] == \
        [ref.wants_probe() for _ in range(32)]


# -- spec_verify ---------------------------------------------------------------


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_spec_verify_targets_are_sequential_draws(temp):
    """Row i's target is `sample()` at (seed, step + i); n_accept counts
    the leading drafts equal to their targets."""
    rng = np.random.default_rng(4)
    b, t, v = 5, 4, 64
    logits = torch.from_numpy(rng.normal(size=(b, t, v)).astype(np.float32))
    temperature = torch.full((b,), temp)
    top_p = torch.full((b,), 0.9)
    top_k = torch.zeros(b, dtype=torch.int64)
    seeds = torch.arange(b, dtype=torch.int64) * 7
    steps = torch.tensor([0, 3, 5, 9, 2])
    seq = torch.stack([sampler.sample(logits[:, i], temperature, top_p, top_k,
                                      seeds, steps + i) for i in range(t)], 1)
    # drafts: all right, wrong at 0, wrong at 1, wrong at 2, all right
    drafts = seq[:, :-1].clone().long()
    for row, bad in ((1, 0), (2, 1), (3, 2)):
        drafts[row, bad] = (drafts[row, bad] + 1) % v
    targets, n_accept = sampler.spec_verify(logits, drafts, temperature,
                                            top_p, top_k, seeds, steps)
    assert torch.equal(targets, seq)
    assert n_accept.tolist() == [3, 0, 1, 2, 3]
    _, none = sampler.spec_verify(logits[:, :1], drafts[:, :0], temperature,
                                  top_p, top_k, seeds, steps)
    assert none.tolist() == [0] * b


# -- forward_spec --------------------------------------------------------------


def test_forward_spec_matches_jax(params):
    """One prefill, then a 4-position verification chunk with deferred
    writes, from the same pool in both frameworks; slot 2 inactive."""
    model = params_from_numpy(params, CFG, device="cpu")
    rng = np.random.default_rng(5)
    b, prompt, t, ps, pages, max_pages = 3, 9, 4, 4, 32, 8
    tables = (np.arange(b * max_pages).reshape(b, max_pages) + 1).astype(
        np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (b, prompt)).astype(np.int32)
    pos = np.tile(np.arange(prompt, dtype=np.int32), (b, 1))
    j_kv, _ = j_forward(params, CFG, jnp.asarray(tokens), jnp.asarray(pos),
                        j_make_kv(CFG, pages, ps), jnp.asarray(tables),
                        jnp.full((b,), prompt, jnp.int32))
    chunk = rng.integers(0, CFG.vocab_size, (b, t)).astype(np.int32)
    cpos = (prompt - 1 + np.arange(t, dtype=np.int32))[None].repeat(b, 0)
    lens = np.full(b, prompt, np.int32)  # committed incl. chunk token 0
    active = np.asarray([True, True, False])
    j_kv2, j_logits = j_forward_spec(
        params, CFG, jnp.asarray(chunk), jnp.asarray(cpos), j_kv,
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(active))
    kv = torch.from_numpy(np.array(j_kv))
    logits = forward_spec(model, torch.from_numpy(chunk).long(),
                          torch.from_numpy(cpos).long(), kv,
                          torch.from_numpy(tables), torch.from_numpy(lens),
                          torch.from_numpy(active))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kv.numpy()[:, :, 1:], np.asarray(j_kv2)[:, :, 1:],
                               rtol=1e-5, atol=1e-5)
    # T = 1 is single-token decode
    kv1 = torch.from_numpy(np.array(j_kv))
    one = forward_spec(model, torch.from_numpy(chunk[:, :1]).long(),
                       torch.from_numpy(cpos[:, :1]).long(), kv1,
                       torch.from_numpy(tables), torch.from_numpy(lens),
                       torch.from_numpy(active))
    kv2 = torch.from_numpy(np.array(j_kv))
    dec = forward_decode(model, torch.from_numpy(chunk[:, 0]).long(),
                         torch.from_numpy(cpos[:, 0]).long(), kv2,
                         torch.from_numpy(tables), torch.from_numpy(lens),
                         torch.from_numpy(active))
    torch.testing.assert_close(one, dec, rtol=0, atol=0)
    torch.testing.assert_close(kv1, kv2, rtol=0, atol=0)


# -- the engine ------------------------------------------------------------------


def _requests(temperature=0.0, max_tokens=24):
    rng = np.random.default_rng(6)
    # repetitive prompts give the n-gram proposer drafts under greedy
    # decoding; a prompt of 39 distinct tokens gives it 1-gram matches for
    # sampled tokens too
    prompts = [REPETITIVE, rng.integers(1, CFG.vocab_size, 13).tolist(),
               [9, 8, 7, 9, 8, 7, 9, 8], list(range(1, 40))]
    return [(f"r{i}", p, temperature if i % 2 == 0 else 0.8, i)
            for i, p in enumerate(prompts)], max_tokens


def _serve(scheduler, make, reqs, max_tokens, timeout=60.0):
    out = {rid: [] for rid, *_ in reqs}
    reasons = {}
    done = threading.Event()
    lock = threading.Lock()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].extend(o.token_ids)
                if o.finish_reason is not None:
                    reasons[rid] = (o.finish_reason, o.error)
                    if len(reasons) == len(reqs):
                        done.set()
        return emit

    for rid, prompt, temp, seed in reqs:
        scheduler.submit(make(rid, prompt, temp, seed, max_tokens),
                         emitter(rid))
    assert done.wait(timeout), "streams did not finish"
    assert all(r == ("length", None) for r in reasons.values()), reasons
    return out


def _port_request(rid, prompt, temp, seed, max_tokens):
    return PreprocessedRequest(
        request_id=rid, token_ids=prompt,
        sampling=SamplingOptions(max_tokens=max_tokens, temperature=temp,
                                 seed=seed),
        stop=StopConditions(ignore_eos=True))


def _jax_request(rid, prompt, temp, seed, max_tokens):
    return JRequest(request_id=rid, token_ids=prompt,
                    sampling=JSampling(max_tokens=max_tokens,
                                       temperature=temp, seed=seed),
                    stop=JStop(ignore_eos=True))


def _run(runner, spec, monkeypatch, reqs, max_tokens, jax_engine=False,
         waves=1, spec_k=3):
    """Serve `reqs` `waves` times through one scheduler (later waves repeat
    the prompts and seeds under new ids, so with speculation on the
    cross-request lookahead proposes what the earlier wave generated)."""
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1" if spec else "0")
    monkeypatch.setenv("DYNT_SPEC_MAX_K", str(spec_k))
    sched = (JScheduler if jax_engine else InferenceScheduler)(runner)
    assert sched.spec_enabled == spec
    sched.start()
    streams = {}
    try:
        for w in range(waves):
            streams.update(_serve(
                sched, _jax_request if jax_engine else _port_request,
                [(f"{w}-{rid}", *rest) for rid, *rest in reqs], max_tokens))
    finally:
        sched.stop()
    return streams, sched.stats


@pytest.mark.parametrize("block", ["1", "4"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_streams_equal_with_spec_on_and_off(runner, block, temperature,
                                            monkeypatch):
    monkeypatch.setenv("DYNT_DECODE_BLOCK", block)
    monkeypatch.setenv("DYNT_DECODE_PIPELINE", "2")
    reqs, max_tokens = _requests(temperature)
    spec_steps = runner.spec_steps
    on, stats = _run(runner, True, monkeypatch, reqs, max_tokens, waves=2)
    off, off_stats = _run(runner, False, monkeypatch, reqs, max_tokens,
                          waves=2)
    assert on == off
    assert all(len(t) == max_tokens for t in on.values())
    # the second wave's streams repeat the first's, so its drafts verify
    assert all(on[f"1-{rid}"] == on[f"0-{rid}"] for rid, *_ in reqs)
    assert stats.spec_steps > 0 and stats.spec_accepted > 0
    assert runner.spec_steps - spec_steps == stats.spec_steps
    assert off_stats.spec_steps == 0
    assert stats.decode_tokens == off_stats.decode_tokens


def test_greedy_spec_stream_matches_jax_engine(params, runner, monkeypatch):
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    monkeypatch.setenv("DYNT_DECODE_PIPELINE", "2")
    reqs, max_tokens = _requests(0.0)
    reqs = [r for r in reqs if r[2] == 0.0]  # sampled: test_torch_sampler.py
    j_runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                       params=params)
    j_streams, j_stats = _run(j_runner, True, monkeypatch, reqs, max_tokens,
                              jax_engine=True)
    streams, stats = _run(runner, True, monkeypatch, reqs, max_tokens)
    assert streams == j_streams
    assert stats.spec_steps > 0 and j_stats.spec_steps > 0
    assert stats.spec_accepted > 0 and j_stats.spec_accepted > 0


# g * head_dim = 1024, the geometry of llama3-70b and qwen3-30b-a3b: with
# the decode kernel's old 3072-wide accumulators a chunk of k + 1 positions
# fit only up to k = 2.
WIDE = dataclasses.replace(CFG, n_q_heads=16, n_kv_heads=2, head_dim=128)


@pytest.mark.parametrize("k", [3, 4, 8])
def test_spec_chunk_beyond_the_old_cap_builds_its_scheduler(k, monkeypatch):
    """Any DYNT_SPEC_MAX_K the reference accepts serves: the folded group
    g' = (k + 1) * g is tiled into the kernel's row tiles, so the scheduler
    builds at g * hd = 1024 with speculation on."""
    r = ModelRunner(dataclasses.replace(WIDE, n_layers=1),
                    RunnerConfig(**RUNNER), device="cpu")
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1")
    monkeypatch.setenv("DYNT_SPEC_MAX_K", str(k))
    sched = InferenceScheduler(r)
    assert sched.spec_enabled and sched.spec_k == k
    rows = (k + 1) * WIDE.n_q_heads // WIDE.n_kv_heads
    plan = tpa.split_plan(RUNNER["max_batch"], WIDE.n_kv_heads, rows,
                          RUNNER["max_pages_per_seq"], RUNNER["page_size"])
    assert plan.row_tile * plan.row_tiles >= rows


def test_greedy_spec_stream_beyond_the_old_cap_matches_jax_engine(
        monkeypatch):
    """At g * hd = 1024 and DYNT_SPEC_MAX_K = 4 (g' * hd = 5120, past the old
    cap) the greedy stream with speculation on equals the stream with it
    off and the JAX engine's, as test_greedy_spec_stream_matches_jax_engine
    checks at tiny-test's geometry."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    monkeypatch.setenv("DYNT_DECODE_PIPELINE", "2")
    params = jax.device_get(j_init(jax.random.PRNGKey(1), WIDE))
    runner = ModelRunner(WIDE, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, WIDE, device="cpu"))
    reqs, max_tokens = _requests(0.0)
    reqs = [r for r in reqs if r[2] == 0.0]
    j_runner = JRunner(WIDE, JRunnerConfig(**RUNNER),
                       make_mesh(MeshConfig()), params=params)
    j_streams, j_stats = _run(j_runner, True, monkeypatch, reqs, max_tokens,
                              jax_engine=True, spec_k=4)
    on, stats = _run(runner, True, monkeypatch, reqs, max_tokens, spec_k=4)
    off, _ = _run(runner, False, monkeypatch, reqs, max_tokens, spec_k=4)
    assert on == off == j_streams
    assert stats.spec_steps > 0 and j_stats.spec_steps > 0
    assert stats.spec_accepted > 0


def test_spec_slack_pages(runner, monkeypatch):
    """A spec-enabled scheduler allocates spec_k + 1 tokens of slack beyond
    the fused-block slack where that is larger."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "1")
    monkeypatch.setenv("DYNT_SPEC_MAX_K", "6")
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1")
    on = InferenceScheduler(runner)
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "0")
    off = InferenceScheduler(runner)
    assert off._page_span(10, 10) == -(-20 // 4)
    assert on._page_span(10, 10) == -(-27 // 4)
    assert on._page_span(10, 10, with_slack=False) == off._page_span(10, 10)


# -- the speculative attention functions in the JAX Pallas interpreter ---------
# (the XLA-oracle comparisons for T = 1..5 are in test_torch_decode_kernels.py)


def _attention_case(t, seed, hd=64, qh=8, kh=2):
    """Inputs for one layer of verification attention: kv_lens are the
    committed lengths including chunk token 0 (1 = no history) up to the
    full 6-page table."""
    rng = np.random.default_rng(seed)
    ps, max_pages, n_pages, lens = 4, 6, 40, [1, 2, 5, 6, 25]
    b = len(lens)
    kv = rng.normal(size=(3, 2, n_pages, ps, kh, hd)).astype(np.float32)
    q = rng.normal(size=(b, t, qh, hd)).astype(np.float32)
    kc = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    vc = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    tables = (rng.permutation(n_pages - 1)[: b * max_pages]
              .reshape(b, max_pages) + 1).astype(np.int32)
    arrs = (q, kv, tables, np.asarray(lens, np.int32), kc, vc)
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@requires_pallas_compiler_params
@pytest.mark.parametrize("t", [1, 3, 5])
def test_spec_attention_matches_pallas_interpret(t):
    """The port's plain versions of both drop-ins against the JAX Pallas
    spec kernels in interpret mode, f32 (1e-4: acc partials over up to 24
    terms |p * v| ~ 1 in two frameworks' f32 orders)."""
    from dynamo_tpu.ops.paged_attention import (
        paged_attention_spec,
        paged_attention_spec_pool,
    )

    (jq, jkv, jtab, jlens, jkc, jvc), (q, kv, tables, lens, kc, vc) = \
        _attention_case(t, seed=5)
    want_pool = paged_attention_spec_pool(jq, jkv, jnp.int32(1), jtab, jlens,
                                          jkc, jvc, interpret=True)
    _close(tpa.paged_attention_spec_pool(q, kv, 1, tables, lens, kc, vc),
           want_pool, 1e-4)
    want = paged_attention_spec(jq, jkv, 1, jtab, jlens, jkc, jvc,
                                interpret=True)
    _close(tpa.paged_attention_spec(q, kv, 1, tables, lens, kc, vc), want,
           1e-4)


@requires_pallas_compiler_params
def test_spec_pool_int8_matches_pallas_interpret():
    """The int8 pool (quantized by JAX, carried over by kv_cache_from_numpy)
    through the folded pool kernel's plain version and JAX's q8 spec kernel
    in interpret mode: identical dequantized values, f32 2e-5."""
    from dynamo_tpu.models.transformer import quantize_kv
    from dynamo_tpu.ops.paged_attention import paged_attention_spec_pool

    (jq, jkv, jtab, jlens, jkc, jvc), (q, _, tables, lens, kc, vc) = \
        _attention_case(3, seed=6, hd=128)
    j_pair = quantize_kv(jkv)
    pair = kv_cache_from_numpy((np.asarray(j_pair[0]), np.asarray(j_pair[1])),
                               device="cpu")
    want = paged_attention_spec_pool(jq, j_pair, jnp.int32(1), jtab, jlens,
                                     jkc, jvc, interpret=True)
    _close(tpa.paged_attention_spec_pool(q, pair, 1, tables, lens, kc, vc),
           want, 2e-5)
