"""Decode-kind steps as graphs (`engine/step_graphs.py`,
`RunnerConfig.cuda_graphs`) against the eager port and the JAX engine, on
tiny-test in float32 on the CPU.

On the CPU a "replay" runs the step's closure over the key's static input
buffers, with the same key selection, copies in, clones out and launch
counter bookkeeping the card's replay has. Checked here: greedy streams
through the scheduler (fused blocks of 4 at pipeline depth 2, and with
speculation) are equal with graphs on and off and equal to the JAX engine's;
a key's result survives the next replay of that key; swapping a step
function on a live runner selects a new key; `prewarm` captures exactly the
documented key set and serving afterwards captures nothing; a replayed step
advances the launch counters exactly as an eager step does.
"""

import dataclasses
import threading

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
from dynamo_tpu_torch.engine import InferenceScheduler, ModelRunner, RunnerConfig
from dynamo_tpu_torch.engine.model_runner import table_widths
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.models.transformer import (
    paged_attention_decode_xla,
    paged_attention_spec_xla,
    paged_attention_xla,
    quant_matmul_ref,
)
from dynamo_tpu_torch.ops import Q8Weight, q8_linear
from dynamo_tpu_torch.ops._launch import count_launch

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=128, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
B = RUNNER["max_batch"]
MAX_TOKENS = 16
SPEC_K = 3
# greedy prompts: two repetitive ones give the n-gram proposer drafts
PROMPTS = [[1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3],
           np.random.default_rng(3).integers(1, CFG.vocab_size, 13).tolist(),
           [9, 8, 7, 9, 8, 7, 9, 8],
           np.random.default_rng(4).integers(1, CFG.vocab_size, 37).tolist()]


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _runner(params, cfg=CFG, **overrides):
    return ModelRunner(cfg, RunnerConfig(**{**RUNNER, **overrides}),
                       device="cpu",
                       params=params_from_numpy(params, cfg, device="cpu"))


def _serve(scheduler, requests, timeout=60.0):
    """Submit every request, wait for every stream; {rid: tokens}."""
    out = {r.request_id: [] for r in requests}
    reasons = {}
    done = threading.Event()
    lock = threading.Lock()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].extend(o.token_ids)
                if o.finish_reason is not None:
                    reasons[rid] = (o.finish_reason, o.error)
                    if len(reasons) == len(requests):
                        done.set()
        return emit

    for r in requests:
        scheduler.submit(r, emitter(r.request_id))
    assert done.wait(timeout), "streams did not finish"
    assert all(r == ("length", None) for r in reasons.values()), reasons
    return out


def _requests(make, sampling, stop, wave=0, logprobs=False):
    return [make(request_id=f"{wave}-{i}", token_ids=p,
                 sampling=sampling(max_tokens=MAX_TOKENS, temperature=0.0,
                                   seed=i, logprobs=logprobs and i == 1),
                 stop=stop(ignore_eos=True))
            for i, p in enumerate(PROMPTS)]


def _port_requests(wave=0, logprobs=False):
    return _requests(PreprocessedRequest, SamplingOptions, StopConditions,
                     wave, logprobs)


def _run(scheduler, waves):
    scheduler.start()
    try:
        streams = {}
        for wave in waves:
            streams.update(_serve(scheduler, wave))
        assert getattr(scheduler, "error", None) is None
        return streams
    finally:
        scheduler.stop()


def _idle_inputs(b=B):
    """(temperature, top_p, top_k, seeds, steps) of greedy slots."""
    return (np.zeros(b, np.float32), np.ones(b, np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.uint32),
            np.zeros(b, np.int32))


@pytest.mark.parametrize("spec", [False, True], ids=["block", "spec"])
def test_greedy_streams_equal_graphs_on_off_and_jax(params, spec,
                                                    monkeypatch):
    """Fused blocks of 4 at pipeline depth 2 (and with speculation on, the
    verification step): the graphed stream == the eager stream == the JAX
    engine's. The graphed runner runs no decode-kind forward eagerly; the
    eager one replays nothing."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    monkeypatch.setenv("DYNT_DECODE_PIPELINE", "2")
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1" if spec else "0")
    monkeypatch.setenv("DYNT_SPEC_MAX_K", str(SPEC_K))
    j_runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                       params=params)
    j_sched = JScheduler(j_runner)
    want = _run(j_sched, [_requests(JRequest, JSampling, JStop)])
    runs = {}
    for graphs in (True, False):
        runner = _runner(params, cuda_graphs=graphs)
        sched = InferenceScheduler(runner)
        assert sched.spec_enabled == spec
        runs[graphs] = (_run(sched, [_port_requests()]), runner, sched.stats)
    (on, g_runner, g_stats), (off, e_runner, e_stats) = runs[True], runs[False]
    assert on == off == want
    assert all(len(t) == MAX_TOKENS for t in on.values())
    if spec:
        assert g_stats.spec_steps > 0 and g_stats.spec_accepted > 0
        assert g_runner.spec_steps == g_stats.spec_steps
        assert j_sched.stats.spec_steps > 0
    assert g_stats.decode_tokens == e_stats.decode_tokens
    assert g_runner.graph_replays > 0 and g_runner.graph_captures > 0
    assert g_runner.eager_forwards == {"decode": 0, "spec": 0, "prefill": 0}
    assert e_runner.graph_replays == e_runner.graph_captures == 0
    assert e_runner.eager_forwards == {"decode": e_runner.decode_steps,
                                       "spec": e_runner.spec_steps,
                                       "prefill": e_runner.prefill_steps}
    assert g_runner.decode_steps == e_runner.decode_steps


def test_a_replay_leaves_the_previous_result_alone(params):
    """Two decode_multi(return_device=True) calls on one key before either is
    read (the scheduler's pipelined dispatch): the first result is still the
    first call's tokens after the second replay."""
    rng = np.random.default_rng(5)
    calls = []
    for first_page in (1, 9):  # disjoint pages: the calls do not interact
        tables = np.zeros((B, 8), np.int32)
        tables[:, :2] = np.arange(first_page, first_page + 2 * B).reshape(B, 2)
        calls.append((rng.integers(1, CFG.vocab_size, B).astype(np.int32),
                      np.full(B, 3, np.int32), tables, np.full(B, 4, np.int32),
                      np.ones(B, bool), *_idle_inputs()))
    results = {}
    for graphs in (True, False):
        runner = _runner(params, cuda_graphs=graphs)
        outs = [runner.decode_multi(*c, k=4, return_device=True)
                for c in calls]
        results[graphs] = [o.numpy().copy() for o in outs]
        if graphs:
            assert runner.graph_captures == 1 and runner.graph_replays == 2
    (g1, g2), (e1, e2) = results[True], results[False]
    np.testing.assert_array_equal(g1, e1)
    np.testing.assert_array_equal(g2, e2)
    assert not np.array_equal(g1, g2)


@pytest.mark.parametrize("name,fn", [
    ("decode_attention_fn", paged_attention_decode_xla),
    ("spec_attention_fn", paged_attention_spec_xla),
    ("matmul_fn", quant_matmul_ref),
    ("attention_fn", paged_attention_xla),
])
def test_swapping_a_step_function_selects_a_new_key(params, name, fn):
    """A graph keeps the functions it was captured with, so a swap on a live
    runner (chip_smoke.py's parity phases do this) captures a new key, and
    swapping back replays the old one."""
    runner = _runner(params)
    tables = np.zeros((B, 8), np.int32)
    args = (np.zeros(B, np.int32), np.zeros(B, np.int32), tables,
            np.zeros(B, np.int32), np.zeros(B, bool), *_idle_inputs())
    drafts = np.zeros((B, SPEC_K), np.int32)

    def both():
        runner.decode(*args)
        runner.decode_spec(args[0], drafts, *args[1:])

    both()
    before = set(runner.step_graphs)
    assert len(before) == 2
    saved = getattr(runner, name)
    assert saved is not fn
    setattr(runner, name, fn)
    both()
    new = set(runner.step_graphs) - before
    assert len(new) == 2 and runner.graph_captures == 4
    assert all(fn in key[-1] for key in new)
    setattr(runner, name, saved)
    both()
    assert runner.graph_captures == 4 and runner.graph_replays == 6


@pytest.mark.parametrize("block,spec", [("1", False), ("4", False),
                                        ("4", True)])
def test_prewarm_captures_the_key_space_and_serving_captures_nothing(
        params, block, spec, monkeypatch):
    """prewarm: for every table-width bucket, the fused block (k =
    DYNT_DECODE_BLOCK, above 1), decode with and without logprobs and its
    logits-processor variant, and with DYNT_SPEC_ENABLE the verification
    step at t = DYNT_SPEC_MAX_K + 1 with and without logits; every prefill
    (padded batch, bucket) with batch x bucket within the largest bucket, at
    the full table width, one forward each after warmup's. Three passes of
    traffic (one request asking for logprobs; the first wave admitted whole,
    so its chunks go out batched; a wave with logits processors) then
    capture nothing and run no forward eagerly."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", block)
    monkeypatch.setenv("DYNT_DECODE_PIPELINE", "2")
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1" if spec else "0")
    monkeypatch.setenv("DYNT_SPEC_MAX_K", str(SPEC_K))
    runner = _runner(params)
    runner.prewarm()
    widths = table_widths(RUNNER["max_pages_per_seq"])
    assert widths == [8, 16]
    want = {("decode", B, w, lp) for w in widths for lp in (False, True)}
    want |= {("decode_logits", B, w, None) for w in widths}
    if block != "1":
        want |= {("decode_multi", B, w, int(block)) for w in widths}
    if spec:
        want |= {(method, B, w, SPEC_K + 1) for w in widths
                 for method in ("decode_spec", "decode_spec_logits")}
    prefill = {("prefill", b, RUNNER["max_pages_per_seq"], bucket)
               for b, bucket in [(1, 8), (2, 8), (4, 8), (1, 16), (2, 16),
                                 (1, 32)]}
    assert {key[:4] for key in runner.step_graphs} == want | prefill
    assert runner.graph_captures == len(want) + len(prefill)
    assert runner.prefill_steps == 1 + len(prefill)
    captures = runner.graph_captures
    replays = runner.graph_replays
    sched = InferenceScheduler(runner)
    processors = _port_requests(2)
    processors[0].sampling.repetition_penalty = 1.3
    processors[2].sampling.logit_bias = {"7": 5.0}
    streams = _run(sched, [_port_requests(0),
                           _port_requests(1, logprobs=True), processors])
    assert all(len(t) == MAX_TOKENS for t in streams.values())
    assert sched.stats.logits_steps > 0
    assert runner.graph_captures == captures
    assert runner.graph_replays > replays
    assert sched.stats.prefill_batched_steps > 0
    assert runner.eager_forwards == {"decode": 0, "spec": 0, "prefill": 0}
    if spec:
        assert sched.stats.spec_steps > 0


def _counting_matmul(x, w):
    """A stand-in for the quantized-matmul kernel on the CPU: counts a launch
    on the q8 wrapper, as the kernel does on the card."""
    count_launch(q8_linear.q8_matmul)
    return quant_matmul_ref(x, w)


@pytest.mark.parametrize("method", ["decode", "decode_multi", "decode_spec"])
def test_replays_advance_launch_counts_as_eager_steps(params, method,
                                                     monkeypatch):
    """With the counting stub as matmul_fn (W8A16 weights): an eager step,
    a key's first call (its eager warm-up forward plus the replay) and a
    later replay. The replay adds exactly the eager step's launches; the
    warm-up forward counts too, as `graph_warm_forwards` says."""
    monkeypatch.setattr(q8_linear.q8_matmul, "launches", 0)
    tables = np.zeros((B, 8), np.int32)
    tables[:, :2] = np.arange(1, 2 * B + 1).reshape(B, 2)
    args = (np.arange(1, B + 1, dtype=np.int32), np.full(B, 3, np.int32),
            tables, np.full(B, 4, np.int32), np.ones(B, bool),
            *_idle_inputs())
    drafts = np.ones((B, SPEC_K), np.int32)
    counts = {}
    for graphs in (False, True):
        runner = _runner(params, weight_dtype="int8", cuda_graphs=graphs)
        runner.matmul_fn = _counting_matmul
        call = {"decode": lambda: runner.decode(*args),
                "decode_multi": lambda: runner.decode_multi(*args, k=3),
                "decode_spec": lambda: runner.decode_spec(
                    args[0], drafts, *args[1:])}[method]
        deltas = []
        for _ in range(2):
            before = q8_linear.q8_matmul.launches
            call()
            deltas.append(q8_linear.q8_matmul.launches - before)
        counts[graphs] = (deltas, runner)
    (eager, e_runner), (graphed, g_runner) = counts[False], counts[True]
    per_forward = sum(isinstance(m, Q8Weight) for m in e_runner.model.modules())
    assert per_forward == 7 * CFG.n_layers  # the head is the tied embedding
    forwards = 3 if method == "decode_multi" else 1
    assert eager == [per_forward * forwards] * 2
    assert graphed == [2 * eager[0], eager[0]]
    kind = "spec" if method == "decode_spec" else "decode"
    assert g_runner.graph_warm_forwards[kind] == forwards
    assert e_runner.graph_warm_forwards == {"decode": 0, "spec": 0,
                                            "prefill": 0}
    (graph,) = g_runner.step_graphs.values()
    assert graph.launches == {"q8_matmul": eager[0]}
    assert g_runner.graph_replays == 2
