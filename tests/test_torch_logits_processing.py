"""The port's logits processors and host-sampling decode path against the JAX
package's, on the CPU.

Primitives: on seeded numpy rows (V = 512) every port processor leaves the
array the reference's leaves (bit-equal f32, -inf included), over a few
steps for the stateful ones, and `host_sample` draws the reference's token
over a grid of temperature / top_p / top_k / seed / step. The registry
resolves the same specs, injects the tokenizer the same way and refuses the
same unknown names.

Engine: tiny-test in float32 with shared weights (`params_from_numpy`),
where the two packages' logits agree to ~3e-6. The port's `TorchWorker` and
the JAX scheduler (with the tokenizer the reference's worker hands it) serve
the same requests, one per processor kind, in two waves (the second repeats
the first's prompts and seeds, so with speculation on the cross-request
lookahead drafts for every slot): the streams and finish reasons are equal
for every kind, with the port's graphs on and off and speculation on and off,
seeded temperature streams included (every token of a processor sequence is
`host_sample`'s). Also pinned: the deferred first token's KV rewrite into a
page the prefix cache shares, a processor failure answering in-band, and an
unknown processor refused in-band.
"""

import contextlib
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.llm import logits_processing as ref_lp
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.llm.tokenizer import ByteTokenizer as RefByteTokenizer
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.llm import logits_processing as lp
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.tokens import compute_block_hashes

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=160, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
V = 512
EOS = ByteTokenizer.EOS
EOS_IDS = [ByteTokenizer.EOS, ByteTokenizer.IM_END]
MAX_TOKENS = 16


# -- primitives --------------------------------------------------------------------

# (processor name, constructor kwargs, steps of input_ids it sees)
PROCESSORS = {
    "logit_bias": ("LogitBiasProcessor",
                   {"bias": {3: 5.0, 7: -2.5, 511: 1.25, 600: 9.0}}, 1),
    "forced_response": ("ForcedResponseProcessor",
                        {"token_ids": [5, 9, 2], "eos_id": EOS}, 5),
    "temperature": ("TemperatureProcessor", {"temperature": 0.7}, 1),
    "penalty": ("PenaltyProcessor",
                {"frequency_penalty": 0.4, "presence_penalty": 0.3}, 4),
    "ban_tokens": ("BanTokensProcessor", {"token_ids": [1, 2, 300]}, 1),
    "repetition": ("RepetitionPenaltyProcessor",
                   {"penalty": 1.3, "prompt_ids": [4, 4, 8, 600]}, 4),
    "min_tokens": ("MinTokensProcessor",
                   {"min_tokens": 3, "eos_ids": [EOS, 260, 900]}, 5),
    "min_p": ("MinPProcessor", {"min_p": 0.05, "temperature": 0.8}, 2),
}


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_rows_bit_equal_to_the_reference(name):
    cls, kwargs, steps = PROCESSORS[name]
    port, ref = getattr(lp, cls)(**kwargs), getattr(ref_lp, cls)(**kwargs)
    rng = np.random.default_rng(sum(map(ord, name)))
    history: list[int] = []
    for _ in range(steps):
        row = (rng.standard_normal(V) * 3).astype(np.float32)
        mine, theirs = row.copy(), row.copy()
        port(list(history), mine)
        ref(list(history), theirs)
        np.testing.assert_array_equal(mine, theirs)
        history += rng.integers(0, V, 2).tolist()


@pytest.mark.parametrize("kind", ["regex", "choice", "json_schema",
                                  "json_object"])
def test_guided_processor_rows_bit_equal_to_the_reference(kind):
    args = {"regex": {"regex": r"[a-c]{2,5}x?"},
            "choice": {"choice": ["alpha", "beta", "gamma"]},
            "json_schema": {"json_schema": {
                "type": "object", "properties": {"ok": {"type": "boolean"}},
                "required": ["ok"]}},
            "json_object": {"json_object": True}}[kind]
    port = lp.resolve_processors([{"name": "guided", "args": args}],
                                 tokenizer=ByteTokenizer())[0]
    ref = ref_lp.resolve_processors([{"name": "guided", "args": args}],
                                    tokenizer=RefByteTokenizer())[0]
    rng = np.random.default_rng(1)
    history: list[int] = []
    for _ in range(8):
        row = rng.standard_normal(V).astype(np.float32)
        mine, theirs = row.copy(), row.copy()
        port(list(history), mine)
        ref(list(history), theirs)
        np.testing.assert_array_equal(mine, theirs)
        history.append(int(np.argmax(mine)))


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.3])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3])
@pytest.mark.parametrize("top_k", [0, 5, 100_000])
@pytest.mark.parametrize("seed", [None, 0, 7])
def test_host_sample_draws_the_reference_token(temperature, top_p, top_k,
                                               seed):
    rng = np.random.default_rng(11)
    for step in (0, 1, 17):
        row = (rng.standard_normal(V) * 2).astype(np.float32)
        row[rng.integers(0, V, 40)] = -np.inf  # masked, as a processor does
        assert (lp.host_sample(row.copy(), temperature, top_p, top_k, seed,
                               step)
                == ref_lp.host_sample(row.copy(), temperature, top_p, top_k,
                                      seed, step))


def test_registry_resolves_injects_the_tokenizer_and_refuses_unknowns():
    assert lp.registered_processors() == ref_lp.registered_processors()
    seen = {}

    def factory(tokenizer=None, tag=""):
        seen["tokenizer"], seen["tag"] = tokenizer, tag
        return lp.BanTokensProcessor([1])

    lp.register_processor("probe_tokenizer", factory)
    try:
        tok = ByteTokenizer()
        procs = lp.resolve_processors(
            [{"name": "probe_tokenizer", "args": {"tag": "x"}},
             {"name": "temperature", "args": {"temperature": 2.0}}],
            tokenizer=tok)
        assert seen == {"tokenizer": tok, "tag": "x"}
        assert [type(p).__name__ for p in procs] == [
            "BanTokensProcessor", "TemperatureProcessor"]
    finally:
        lp._REGISTRY.pop("probe_tokenizer")
    with pytest.raises(ValueError) as mine:
        lp.resolve_processors(["nope"])
    with pytest.raises(ValueError) as theirs:
        ref_lp.resolve_processors(["nope"])
    assert str(mine.value) == str(theirs.value)


# -- the engine --------------------------------------------------------------------

_rng = np.random.default_rng(21)
REPETITIVE = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3]
# kind -> (prompt, sampling kwargs, stop kwargs, logits_processors)
KINDS = {
    "repetition": (REPETITIVE, {"repetition_penalty": 1.3}, {}, []),
    "frequency_presence": (
        [9, 8, 7, 9, 8, 7, 9, 8],
        {"frequency_penalty": 0.5, "presence_penalty": 0.5}, {}, []),
    "logit_bias": (_rng.integers(1, 256, 13).tolist(),
                   {"logit_bias": {"97": 3.0, "98": 3.0}}, {}, []),
    "min_tokens_eos_biased": (
        _rng.integers(1, 256, 9).tolist(), {"logit_bias": {str(EOS): 100.0}},
        {"min_tokens": 6, "ignore_eos": False}, []),
    "min_tokens_retires": (REPETITIVE[:7], {},
                           {"min_tokens": 4, "ignore_eos": False}, []),
    "min_p_seeded": (list(range(30, 60)),
                     {"temperature": 0.8, "top_p": 0.9, "min_p": 0.1,
                      "seed": 7}, {}, []),
    "penalty_seeded_top_k": (
        REPETITIVE, {"temperature": 1.1, "top_k": 20, "seed": 11,
                     "frequency_penalty": 0.2}, {}, []),
    "forced_response": (
        [5, 6, 7], {}, {"ignore_eos": False},
        [{"name": "forced_response",
          "args": {"token_ids": [72, 105, 33, 72], "eos_id": EOS}}]),
    "guided_regex": (
        [97, 98, 99, 97, 98, 99, 97], {}, {"ignore_eos": False},
        [{"name": "guided", "args": {"regex": "[a-c]{3,9}"}}]),
    "guided_choice_seeded": (
        [40, 41, 42], {"temperature": 1.0, "seed": 3},
        {"ignore_eos": False},
        [{"name": "guided", "args": {"choice": ["alpha", "beta", "gamma"]}}]),
}


def _make(make_req, make_samp, make_stop, rid, kind):
    prompt, samp, stop, procs = KINDS[kind]
    stop = {"ignore_eos": True, **stop}
    return make_req(
        request_id=rid, token_ids=list(prompt),
        sampling=make_samp(**{"max_tokens": MAX_TOKENS, "temperature": 0.0,
                              "seed": 0, **samp}),
        stop=make_stop(**stop), eos_token_ids=list(EOS_IDS),
        logits_processors=[dict(p) for p in procs])


def _serve(scheduler, requests, timeout=60.0):
    """Submit every request, wait for every stream and for the scheduler
    to release every sequence: {rid: (tokens, finish_reason, error)}. Both
    engines emit a stream's last token before the end of the step that
    releases its pages into the prefix cache."""
    deadline = time.monotonic() + timeout
    out = {r.request_id: [] for r in requests}
    ends = {}
    done = threading.Event()
    lock = threading.Lock()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].extend(o.token_ids)
                if o.finish_reason is not None:
                    ends[rid] = (o.finish_reason, o.error)
                    if len(ends) == len(requests):
                        done.set()
        return emit

    for r in requests:
        scheduler.submit(r, emitter(r.request_id))
    assert done.wait(timeout), "streams did not finish"
    while scheduler._waiting or any(s is not None for s in scheduler._slots):
        assert time.monotonic() < deadline, "sequences were not released"
        time.sleep(0.001)
    return {rid: (out[rid], *ends[rid]) for rid in out}


@contextlib.contextmanager
def _knobs(spec):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNT_DECODE_BLOCK", "4")
        mp.setenv("DYNT_DECODE_PIPELINE", "2")
        mp.setenv("DYNT_SPEC_ENABLE", "1" if spec else "0")
        mp.setenv("DYNT_SPEC_MAX_K", "3")
        yield


def _waves(scheduler, make):
    streams = {}
    for wave in range(2):
        streams.update(_serve(scheduler, [make(f"{wave}-{k}", k)
                                          for k in sorted(KINDS)]))
    assert getattr(scheduler, "error", None) is None
    return streams


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def jax_streams(params):
    """{spec: (streams, stats)} from the JAX scheduler."""
    runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                     params=params)
    out = {}
    for spec in (False, True):
        with _knobs(spec):
            sched = JScheduler(runner)
            sched.logits_tokenizer = RefByteTokenizer()  # as TpuWorker does
            sched.start()
            try:
                out[spec] = (_waves(sched, lambda rid, k: _make(
                    JRequest, JSampling, JStop, rid, k)), sched.stats)
            finally:
                sched.stop()
    return out


@pytest.fixture(scope="module")
def port_streams(params):
    """{(graphs, spec): (streams, stats, runner)} from the port's worker."""
    out = {}
    for graphs in (True, False):
        for spec in (False, True):
            with _knobs(spec):
                worker = TorchWorker(
                    CFG, RunnerConfig(**RUNNER, cuda_graphs=graphs),
                    device="cpu",
                    params=params_from_numpy(params, CFG, device="cpu"))
                worker.start()
                try:
                    out[graphs, spec] = (_waves(
                        worker.scheduler, lambda rid, k: _make(
                            PreprocessedRequest, SamplingOptions,
                            StopConditions, rid, k)),
                        worker.scheduler.stats, worker.runner)
                finally:
                    worker.close()
    return out


@pytest.mark.parametrize("spec", [False, True], ids=["seq", "spec"])
@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_streams_equal_the_jax_engine(port_streams, jax_streams, kind,
                                      graphs, spec):
    mine = port_streams[graphs, spec][0]
    theirs = jax_streams[spec][0]
    for wave in range(2):
        rid = f"{wave}-{kind}"
        assert mine[rid] == theirs[rid], rid
        assert mine[rid][2] is None
    # with spec off the port's streams are the same again
    assert mine[f"0-{kind}"] == port_streams[graphs, False][0][f"0-{kind}"]


def test_each_kind_does_what_it_says(port_streams):
    streams = port_streams[True, False][0]
    toks = {k: streams[f"0-{k}"][0] for k in KINDS}
    ends = {k: streams[f"0-{k}"][1] for k in KINDS}
    # min_tokens with EOS biased up: stop after exactly 6 non-EOS tokens
    assert ends["min_tokens_eos_biased"] == "stop"
    assert len(toks["min_tokens_eos_biased"]) == 7
    assert toks["min_tokens_eos_biased"][-1] == EOS
    assert EOS not in toks["min_tokens_eos_biased"][:-1]
    assert toks["forced_response"] == [72, 105, 33, 72, EOS]
    guided = toks["guided_regex"]
    assert guided[-1] in EOS_IDS and 3 <= len(guided) - 1 <= 9
    assert all(97 <= t <= 99 for t in guided[:-1])
    assert bytes(toks["guided_choice_seeded"][:-1]).decode() in (
        "alpha", "beta", "gamma")
    assert all(ends[k] in ("stop", "length") for k in KINDS)


def test_every_config_ran_the_processor_paths(port_streams, jax_streams):
    for (graphs, spec), (_streams, stats, runner) in port_streams.items():
        assert stats.logits_steps > 0
        assert runner.logits_reads > 0 and runner.logits_bytes_read > 0
        assert set(stats.host_ms) >= {"host_sample", "MinPProcessor",
                                      "GuidedProcessor",
                                      "RepetitionPenaltyProcessor"}
        if graphs:
            assert runner.eager_forwards == {"decode": 0, "spec": 0,
                                             "prefill": 0}
            assert any(k[0] == "decode_logits" for k in runner.step_graphs)
        if spec:
            # processor slots rode along in verification steps
            assert stats.spec_logits_steps > 0 and stats.spec_steps > 0
            assert any(k[0] == "decode_spec_logits"
                       for k in runner.step_graphs) == graphs
        else:
            assert stats.spec_steps == 0
    assert jax_streams[True][1].spec_steps > 0


def test_logits_rows_are_the_asked_slots_only(params):
    """decode(want_logits=True, logits_slots=...) copies only those rows,
    in that order, equal to the full [B, V] logits' rows."""
    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    runner = worker.runner
    b = RUNNER["max_batch"]
    tables = np.zeros((b, 8), np.int32)
    tables[:, :2] = np.arange(1, 2 * b + 1).reshape(b, 2)
    args = (np.arange(1, b + 1, dtype=np.int32), np.full(b, 3, np.int32),
            tables, np.full(b, 4, np.int32), np.ones(b, bool),
            np.zeros(b, np.float32), np.ones(b, np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.uint32))
    tokens_all = runner.decode(*args, want_logits=True)
    full = runner.last_decode_logits.copy()
    assert full.shape == (b, V)
    before = runner.logits_bytes_read
    tokens = runner.decode(*args, want_logits=True, logits_slots=[2, 0])
    np.testing.assert_array_equal(tokens, tokens_all)
    np.testing.assert_array_equal(runner.last_decode_logits, full[[2, 0]])
    assert runner.logits_bytes_read - before == 2 * V * 4
    drafts = np.zeros((b, 2), np.int32)
    targets, n_acc = runner.decode_spec(args[0], drafts, *args[1:],
                                        want_logits=True, logits_slots=[3])
    assert runner.last_spec_logits.shape == (1, 3, V)
    np.testing.assert_array_equal(runner.last_spec_logits[0, 0], full[3])
    worker.close()


def test_deferred_first_token_rewrites_a_shared_cached_page(params):
    """A processor request whose whole prompt is cached recomputes only its
    last prompt token, as the reference does (prefill_pos = prompt_len - 1),
    into the page the prefix cache shares; its deferred first decode step
    writes that position once more. The page keeps its values (to rounding)
    and the stream equals the JAX engine's."""
    prompt = _rng.integers(1, 256, 12).tolist()  # 3 full pages of 4

    def requests(make_req, make_samp, make_stop):
        a = make_req(request_id="a", token_ids=list(prompt),
                     sampling=make_samp(max_tokens=6, temperature=0.0),
                     stop=make_stop(ignore_eos=True))
        b = make_req(request_id="b", token_ids=list(prompt),
                     sampling=make_samp(max_tokens=6, temperature=0.0,
                                        repetition_penalty=1.3),
                     stop=make_stop(ignore_eos=True))
        return a, b

    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    worker.start()
    try:
        sched = worker.scheduler
        a, b = requests(PreprocessedRequest, SamplingOptions, StopConditions)
        mine = _serve(sched, [a])
        hashes = compute_block_hashes(prompt, RUNNER["page_size"],
                                      lora_id=a.kv_salt())
        page = sched.pool._cached[hashes[2]]
        kv = worker.runner.kv_cache
        before = kv[:, :, page, 3].clone()
        prefilled = sched.stats.prefill_tokens
        mine.update(_serve(sched, [b]))
        assert sched.stats.prefill_tokens - prefilled == 1
        assert sched.pool._cached[hashes[2]] == page
        torch.testing.assert_close(kv[:, :, page, 3], before, rtol=0,
                                   atol=1e-5)
    finally:
        worker.close()
    runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                     params=params)
    j_sched = JScheduler(runner)
    j_sched.start()
    try:
        ja, jb = requests(JRequest, JSampling, JStop)
        theirs = _serve(j_sched, [ja])
        theirs.update(_serve(j_sched, [jb]))
    finally:
        j_sched.stop()
    assert mine == theirs


@pytest.mark.parametrize("spec", [
    ([{"name": "nope"}], "logits processors: unknown logits processor"),
    ([{"name": "guided", "args": {"regex": "("}}], "logits processors:"),
    ([{"name": "ban_tokens", "args": {"token_ids": [10 ** 6]}}],
     "logits processor failed"),
], ids=["unknown", "bad-regex", "raises-at-step"])
def test_processor_errors_answer_in_band(params, spec):
    """An unknown processor, a grammar that does not compile and a processor
    that raises mid-stream finish their request with an error; a plain
    request beside them is served."""
    procs, message = spec
    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    worker.start()
    try:
        bad = _make(PreprocessedRequest, SamplingOptions, StopConditions,
                    "bad", "repetition")
        bad.logits_processors = procs
        good = _make(PreprocessedRequest, SamplingOptions, StopConditions,
                     "good", "logit_bias")
        out = _serve(worker.scheduler, [bad, good])
    finally:
        worker.close()
    assert out["bad"][1] == "error" and out["bad"][2].startswith(message)
    assert out["good"][1] == "length" and len(out["good"][0]) == MAX_TOKENS
    assert worker.scheduler.error is None
