"""The port's engine serving MLA models, held against the JAX engine on the
CPU: TorchWorker's scheduler and the reference's, pumped alike on the test
thread (tests/test_torch_preemption.py's pattern), over tiny-mla-test, a
mixed dense/MoE DeepSeek stack and a V3-shaped config (the configs and
params of tests/test_torch_mla.py, float32). Tolerance 0: token ids, and
the prompt tokens each engine computes.
"""

import numpy as np
import pytest

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import params_from_numpy

from test_torch_mla import CONFIGS, RUNNER, _params


@pytest.fixture(scope="module")
def params():
    return {name: _params(cfg) for name, cfg in CONFIGS.items()}


PROMPT_LENGTHS = (21, 13)
MAX_TOKENS = 12


class Stream:
    def __init__(self):
        self.tokens: list = []
        self.finish = None

    def emit(self, out) -> None:
        self.tokens += out.token_ids
        if out.finish_reason is not None:
            self.finish = out.finish_reason


def _pump(sched, done, limit=500) -> None:
    """Run the scheduler's loop body on this thread until `done()`."""
    for _ in range(limit):
        if done():
            return
        sched._drain_control()
        sched._drain_incoming()
        if not sched._step():
            sched._drain_gap()
    raise AssertionError("the scheduler stalled")


def _serve(sched, pkg, vocab):
    """Two prompts as one batch, then once they finish a third that
    shares the first's 16-token prefix (4 cached pages of 4)."""
    req, samp, stop = ((PreprocessedRequest, SamplingOptions, StopConditions)
                       if pkg == "port" else (JRequest, JSampling, JStop))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENGTHS]
    prompts.append(prompts[0][:16] + rng.integers(1, vocab, 7).tolist())
    streams = [Stream() for _ in prompts]

    def submit(i):
        sched.submit(req(request_id=f"{pkg}-{i}", token_ids=prompts[i],
                         sampling=samp(max_tokens=MAX_TOKENS,
                                       temperature=0.0, seed=i),
                         stop=stop(ignore_eos=True)), streams[i].emit)

    submit(0)
    submit(1)
    _pump(sched, lambda: all(s.finish for s in streams[:2]))
    prefilled = sched.stats.prefill_tokens
    submit(2)
    _pump(sched, lambda: streams[2].finish is not None)
    return ([(s.tokens, s.finish) for s in streams],
            sched.stats.prefill_tokens - prefilled)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_worker_greedy_streams_equal_the_jax_engine(params, name,
                                                    monkeypatch):
    """TorchWorker's scheduler and the JAX engine's, pumped alike, emit the
    same greedy tokens per stream: a batch of two, then a prompt whose
    first 16 tokens hit the prefix cache (both compute only its last 7),
    through fused decode blocks of the unified forward. With
    DYNT_SPEC_ENABLE=1 neither speculates."""
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1")
    cfg = CONFIGS[name]
    worker = TorchWorker(cfg, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params[name], cfg,
                                                  device="cpu"))
    assert worker.scheduler.spec_enabled is False
    got, got_prefill = _serve(worker.scheduler, "port", cfg.vocab_size)
    ref = JScheduler(JRunner(cfg, JRunnerConfig(**RUNNER),
                             make_mesh(MeshConfig()), params=params[name]))
    assert not ref.spec_enabled
    want, want_prefill = _serve(ref, "ref", cfg.vocab_size)
    assert got == want
    assert got_prefill == want_prefill == 7
    assert all(finish == "length" and len(tokens) == MAX_TOKENS
               for tokens, finish in got)
    runner = worker.runner
    assert any(key[0] == "decode_multi" for key in runner.step_graphs)
    assert runner.spec_steps == 0
    assert runner.eager_forwards == {"decode": 0, "spec": 0, "prefill": 0}
