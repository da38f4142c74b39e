"""The unified T = 1 decode of the port: a caller-supplied `attention_fn`
(`ops.paged_attention.paged_attention`, whose decode branch is kernel row 3)
against the default deferred-write path and against the JAX package's
unified path, `ModelRunner(attention_fn=paged_attention_xla)`.

tiny-test in float32 on the CPU, weights shared through `params_from_numpy`.
Greedy streams must be identical: the unified forward writes each layer's
K/V before it attends, the deferred path attends over the history plus the
in-register current token, and the two agree to ~1e-6 in f32, far below any
greedy margin on these prompts. The dispatcher itself is held against JAX's
`paged_attention_xla` (f32 2e-5, bf16 2e-2: one bf16 ulp at |x| ~ 2) and,
in interpret mode, against JAX's `paged_attention`.
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
from dynamo_tpu.models import transformer as jt
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import (
    InferenceScheduler,
    ModelRunner,
    RunnerConfig,
    TorchWorker,
)
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import kv_cache_from_numpy, params_from_numpy
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.ops.paged_attention import paged_attention
from jax_capabilities import requires_pallas_compiler_params

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=128, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
MAX_TOKENS = 10
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _prompts():
    rng = np.random.default_rng(7)
    first = rng.integers(1, CFG.vocab_size, 13).tolist()
    # one shares `first`'s leading 2 pages (a prefix-cache hit), one is
    # longer than the 32-token chunk budget, one is a single token
    return [first, first[:8] + rng.integers(1, CFG.vocab_size, 5).tolist(),
            rng.integers(1, CFG.vocab_size, 37).tolist(), [5]]


def _serve(scheduler, requests, timeout=60.0):
    out = {r.request_id: [] for r in requests}
    done = threading.Event()
    lock = threading.Lock()
    finished = set()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].extend(o.token_ids)
                if o.finish_reason is not None:
                    assert o.finish_reason == "length", o.error
                    finished.add(rid)
                    if len(finished) == len(requests):
                        done.set()
        return emit

    for r in requests:
        scheduler.submit(r, emitter(r.request_id))
    assert done.wait(timeout), "streams did not finish"
    return out


def _requests(make_req, make_samp, make_stop):
    return [make_req(request_id=f"r{i}", token_ids=p,
                     sampling=make_samp(max_tokens=MAX_TOKENS, temperature=0.0,
                                        seed=i),
                     stop=make_stop(ignore_eos=True))
            for i, p in enumerate(_prompts())]


def _port_streams(params, attention_fn):
    runner = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"),
                         attention_fn=attention_fn)
    sched = InferenceScheduler(runner)
    sched.start()
    try:
        out = _serve(sched, _requests(PreprocessedRequest, SamplingOptions,
                                      StopConditions))
        assert sched.error is None
        return out, runner
    finally:
        sched.stop()


@pytest.mark.parametrize("block", ["1", "4"])
def test_unified_greedy_streams_match_default_and_jax(params, block,
                                                      monkeypatch):
    monkeypatch.setenv("DYNT_DECODE_BLOCK", block)
    monkeypatch.setenv("DYNT_DECODE_PIPELINE", "2")
    unified, runner = _port_streams(params, paged_attention)
    default, _ = _port_streams(params, None)
    j_runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                       params=params, attention_fn=jt.paged_attention_xla)
    j_sched = JScheduler(j_runner)
    j_sched.start()
    try:
        j_unified = _serve(j_sched, _requests(JRequest, JSampling, JStop))
    finally:
        j_sched.stop()
    assert unified == default == j_unified
    assert all(len(t) == MAX_TOKENS for t in unified.values())
    assert runner.decode_steps > 0 and runner.spec_steps == 0


def test_unified_decode_writes_then_attends(params):
    """One unified decode step writes the token's K/V into every layer's
    pages before attending (the pool the default path writes after), and
    gives the default path's logits."""
    model_params = params_from_numpy(params, CFG, device="cpu")
    runners = [ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                           params=model_params, attention_fn=fn)
               for fn in (paged_attention, None)]
    prompt = np.arange(1, 12, dtype=np.int32)
    table = np.zeros(RUNNER["max_pages_per_seq"], np.int32)
    table[:4] = [3, 7, 9, 2]
    logits = []
    for r in runners:
        first = r.prefill_chunk(prompt, 0, table, len(prompt), (0.0, 1.0, 0, 0))
        r.decode(np.asarray([first, 0]), np.asarray([11, 0]),
                 np.stack([table[:4], np.zeros(4, np.int32)]),
                 np.asarray([12, 0]), np.asarray([True, False]),
                 np.zeros(2, np.float32), np.ones(2, np.float32),
                 np.zeros(2, np.int32), np.zeros(2, np.uint32),
                 want_logits=True)
        logits.append(r.last_decode_logits[0])
    np.testing.assert_allclose(logits[0], logits[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runners[0].kv_cache[:, :, 1:].numpy(),
                               runners[1].kv_cache[:, :, 1:].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert runners[0].supports_spec is False and runners[1].supports_spec


def test_attention_fn_turns_speculation_off(params, monkeypatch, run):
    """As in the reference: with a caller's attention_fn the scheduler does
    not speculate even with DYNT_SPEC_ENABLE set, and TorchWorker passes the
    function through to the runner."""
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1")
    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"),
                         attention_fn=paged_attention)
    assert worker.runner.attention_fn is paged_attention
    assert not worker.scheduler.spec_enabled
    worker.start()
    try:
        body = _requests(PreprocessedRequest, SamplingOptions,
                         StopConditions)[0].to_wire()

        async def collect():
            return [d async for d in worker.generate(body)]

        frames = run(collect())
    finally:
        worker.close()
    assert frames[-1]["f"] == "length"
    assert sum(len(f.get("t", [])) for f in frames) == MAX_TOKENS


def _case(t, seed=2, hd=64, qh=8, kh=2):
    rng = np.random.default_rng(seed)
    n_layers, n_pages, ps, max_pages = 2, 24, 4, 5
    lens = np.asarray([1, 4, 5, 20], np.int32)  # incl. this chunk
    b = len(lens)
    kv = rng.normal(size=(n_layers, 2, n_pages, ps, kh, hd)).astype(np.float32)
    q = rng.normal(size=(b, t, qh, hd)).astype(np.float32)
    tables = (rng.permutation(n_pages - 1)[: b * max_pages]
              .reshape(b, max_pages) + 1).astype(np.int32)
    positions = (lens[:, None] - t + np.arange(t)[None, :]).astype(np.int32)
    return q, kv, tables, positions, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 3])
def test_dispatcher_matches_jax_xla(dtype, t):
    """T == 1 runs row 3's plain version, T > 1 the plain prefill attention;
    both equal JAX's `paged_attention_xla` for the same pool."""
    q, kv, tables, positions, lens = _case(t)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jt.paged_attention_xla(jnp.asarray(q, jdt), jnp.asarray(kv, jdt), 1,
                                  jnp.asarray(tables), jnp.asarray(positions),
                                  jnp.asarray(lens))
    got = paged_attention(torch.from_numpy(q).to(tdt),
                          torch.from_numpy(kv).to(tdt), 1,
                          torch.from_numpy(tables),
                          torch.from_numpy(positions).long(),
                          torch.from_numpy(lens))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=_TOL[dtype], atol=_TOL[dtype])


def test_dispatcher_sends_int8_pools_to_the_plain_path():
    """An int8 pool takes the plain attention for T == 1 too, as in the
    reference (row 3 is bf16 only); row 3 never counts a launch here."""
    tpa.paged_decode_attention.launches = 0
    q, kv, tables, positions, lens = _case(1, hd=128)
    j_pair = jt.quantize_kv(jnp.asarray(kv))
    want = jt.paged_attention_xla(jnp.asarray(q), j_pair, 0,
                                  jnp.asarray(tables), jnp.asarray(positions),
                                  jnp.asarray(lens))
    got = paged_attention(torch.from_numpy(q), kv_cache_from_numpy(
        (np.asarray(j_pair[0]), np.asarray(j_pair[1])), device="cpu"), 0,
        torch.from_numpy(tables), torch.from_numpy(positions).long(),
        torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert tpa.paged_decode_attention.launches == 0


@requires_pallas_compiler_params
def test_dispatcher_matches_jax_pallas_interpret():
    from dynamo_tpu.ops.paged_attention import paged_attention as j_attention

    q, kv, tables, positions, lens = _case(1, seed=3)
    want = j_attention(jnp.asarray(q), jnp.asarray(kv), 1,
                       jnp.asarray(tables), jnp.asarray(positions),
                       jnp.asarray(lens), interpret=True)
    got = paged_attention(torch.from_numpy(q), torch.from_numpy(kv), 1,
                          torch.from_numpy(tables),
                          torch.from_numpy(positions).long(),
                          torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
