"""The port's engine (scheduler + runner + worker) against the JAX engine with
the same weights (tiny-test, float32, CPU).

Greedy token streams must be identical: decoding is deterministic given the
logits, and the two engines' logits agree to ~1e-6 (see
test_torch_transformer.py). Covers continuous batching of concurrent
requests, chunked prefill (prompts longer than the chunk budget), a prefix
cache hit on full pages, fused decode blocks with pipelined dispatch
(DYNT_DECODE_BLOCK 4) and per-token decode (DYNT_DECODE_BLOCK 1).
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
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
from dynamo_tpu_torch.models import params_from_numpy

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=64, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
MAX_TOKENS = 10


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _prompts():
    rng = np.random.default_rng(7)
    first = rng.integers(1, CFG.vocab_size, 13).tolist()
    # wave 2: one shares `first`'s leading 2 full pages (prefix-cache hit),
    # one is longer than the 32-token chunk budget (chunked prefill)
    shared = first[:8] + rng.integers(1, CFG.vocab_size, 5).tolist()
    long = rng.integers(1, CFG.vocab_size, 37).tolist()
    other = rng.integers(1, CFG.vocab_size, 6).tolist()
    return [first], [shared, long, other]


def _serve(scheduler, requests, timeout=60.0):
    """Submit all, wait until every stream finishes and the scheduler has
    released every sequence; returns {rid: (tokens, finish reasons)}.

    Both engines emit a stream's last token before they release its pages
    (the release ends the step that emitted it), and both admit arrivals in
    the middle of a step. Returning on the last emit alone let the next
    wave be admitted before the previous wave's prompt blocks reached the
    prefix cache whenever the scheduler thread was slow to reach the end of
    its step, as it is on a loaded host: the prefix-cache hit that the
    caller counts on then depended on thread timing."""
    deadline = time.monotonic() + timeout
    out = {r.request_id: [] for r in requests}
    done = threading.Event()
    lock = threading.Lock()
    finished = set()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].append(o)
                if o.finish_reason is not None:
                    finished.add(rid)
                    if len(finished) == len(requests):
                        done.set()
        return emit

    for r in requests:
        scheduler.submit(r, emitter(r.request_id))
    assert done.wait(timeout), "streams did not finish"
    while scheduler._waiting or any(s is not None for s in scheduler._slots):
        assert time.monotonic() < deadline, "sequences were not released"
        time.sleep(0.001)
    return {rid: ([t for o in outs for t in o.token_ids],
                  [o.finish_reason for o in outs if o.finish_reason])
            for rid, outs in out.items()}


def _run_jax(params, waves):
    runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                     params=params)
    sched = JScheduler(runner)
    sched.start()
    try:
        streams = {}
        for w, wave in enumerate(waves):
            streams.update(_serve(sched, [
                JRequest(request_id=f"{w}-{i}", token_ids=p,
                         sampling=JSampling(max_tokens=MAX_TOKENS,
                                            temperature=0.0, seed=i),
                         stop=JStop(ignore_eos=True))
                for i, p in enumerate(wave)]))
        return streams, sched.stats.prefill_tokens
    finally:
        sched.stop()


def _port_requests(w, wave):
    return [PreprocessedRequest(
        request_id=f"{w}-{i}", token_ids=p,
        sampling=SamplingOptions(max_tokens=MAX_TOKENS, temperature=0.0,
                                 seed=i),
        stop=StopConditions(ignore_eos=True)) for i, p in enumerate(wave)]


def _run_port(params, waves):
    runner = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    sched = InferenceScheduler(runner)
    sched.start()
    try:
        streams = {}
        for w, wave in enumerate(waves):
            streams.update(_serve(sched, _port_requests(w, wave)))
        assert sched.error is None
        return streams, sched.stats.prefill_tokens, runner
    finally:
        sched.stop()


@pytest.mark.parametrize("block", ["1", "4"])
def test_greedy_streams_match_jax_engine(params, block, monkeypatch):
    monkeypatch.setenv("DYNT_DECODE_BLOCK", block)
    monkeypatch.setenv("DYNT_DECODE_PIPELINE", "2")
    waves = _prompts()
    j_streams, j_prefilled = _run_jax(params, waves)
    p_streams, p_prefilled, runner = _run_port(params, waves)
    assert p_streams == j_streams
    for tokens, reasons in p_streams.values():
        assert len(tokens) == MAX_TOKENS and reasons == ["length"]
    # the shared request reused 2 cached pages (8 tokens) in both engines
    n_prompt = sum(len(p) for wave in waves for p in wave)
    assert p_prefilled == j_prefilled == n_prompt - 8
    assert runner.decode_steps > 0


def test_worker_generate_wire_stream(params, run, monkeypatch):
    """TorchWorker.generate: wire dict in, EngineOutput wire dicts out, the
    same greedy stream the JAX engine produces."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    (prompt,), _ = _prompts()
    j_streams, _ = _run_jax(params, [[prompt]])
    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    worker.start()
    try:
        body = _port_requests(0, [prompt])[0].to_wire()

        async def collect():
            return [d async for d in worker.generate(body)]

        frames = run(collect())
    finally:
        worker.close()
    assert all(set(f) <= {"t", "f", "p"} for f in frames)
    assert frames[0]["p"] == len(prompt)
    assert frames[-1]["f"] == "length"
    assert all("f" not in f for f in frames[:-1])
    assert [t for f in frames for t in f["t"]] == j_streams["0-0"][0]


@pytest.mark.parametrize("feature", [
    {"lora_name": "adapter"},
    {"media_hashes": [123]},
    {"annotations": {"embed": True}},
], ids=["lora", "multimodal", "embed"])
def test_unported_request_features_error_in_band(params, run, feature):
    """Multimodal requests are not ported and error in band; an adapter
    request on a worker without that adapter gets the reference's in-band
    refusal; an embedding request gets the reference's one `stop` frame
    carrying the pooled vector (`emb`), equal to the JAX package's
    `forward_embed` at the bucket (f32, within 1e-5)."""
    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    worker.start()
    try:
        body = PreprocessedRequest(
            request_id="x", token_ids=[1, 2, 3],
            sampling=SamplingOptions(max_tokens=4),
            stop=StopConditions(), **feature).to_wire()

        async def collect():
            return [d async for d in worker.generate(body)]

        frames = run(collect())
    finally:
        worker.close()
    if "annotations" in feature:
        from dynamo_tpu.models.transformer import forward_embed
        tok = np.zeros((1, 8), np.int32)
        tok[0, :3] = [1, 2, 3]
        want = np.asarray(forward_embed(params, CFG, tok,
                                        np.arange(8)[None] < 3))[0]
        assert len(frames) == 1 and frames[0]["f"] == "stop"
        assert frames[0]["p"] == 3 and "err" not in frames[0]
        np.testing.assert_allclose(frames[0]["emb"], want, atol=1e-5)
        return
    want = ("adapter 'adapter' not loaded here" if "lora_name" in feature
            else "not ported yet")
    assert frames[-1]["f"] == "error" and want in frames[-1]["err"]
