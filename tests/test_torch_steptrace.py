"""The port's device-time attribution (`perf/steptrace.py`) and its
analytical model (`profiler/`) against the JAX package's, then the port's
scheduler and worker using them (tiny-test, float32, CPU; no process
spawned, no socket bound).

  * one fake-clock script of begin / dispatch / drain / sync / commit gives
    the reference's StepSamples, totals and host-bound verdict exactly;
  * param_count, kv_bytes_per_token, TimingModel and LiveRoofline give the
    reference's numbers (LiveRoofline's (mfu, fraction) to 1e-12 relative)
    for the same configuration and chip spec;
  * the scheduler commits steps whose host and device parts sum to the wall,
    with decode, prefill and sync windows where the reference puts them, and
    mirrors the last one into its stats; the worker publishes the step
    histograms, the host-bound verdict and the MFU / roofline gauges.
"""

import dataclasses
import itertools
import queue as thread_queue
import threading
import time

import numpy as np
import pytest

from dynamo_tpu.models import get_config
from dynamo_tpu.perf import steptrace as ref_st
from dynamo_tpu.profiler import chips as ref_chips
from dynamo_tpu.profiler import timing_model as ref_tm
from dynamo_tpu_torch.engine import (
    InferenceScheduler,
    ModelRunner,
    RunnerConfig,
    TorchWorker,
)
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models import get_config as port_config
from dynamo_tpu_torch.perf import steptrace
from dynamo_tpu_torch.profiler import chips, timing_model
from dynamo_tpu_torch.runtime import metrics

CFG = dataclasses.replace(port_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=64, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
PRESETS = ("tiny-test", "llama3-8b", "mistral-7b")


class _Clock:
    """A clock that moves only when the script says so."""

    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _script(rng: np.random.Generator, steps: int) -> list:
    """A step script: per step, a list of (op, phase, arg) with the clock
    advanced by `dt` seconds before each op. The ops cover every scope and
    both drain anchors."""
    out = []
    for _ in range(steps):
        ops = [("begin", None, None)]
        kinds = rng.choice(["decode", "spec", "prefill", "sync", "late"],
                           size=rng.integers(1, 4), replace=False)
        for kind in kinds:
            if kind == "sync":
                ops.append(("sync", str(rng.choice(["decode", "prefill"])),
                            None))
            elif kind == "late":
                ops.append(("drain", "prefill", False))
            else:
                ops.append(("dispatch", str(kind), None))
                ops.append(("drain", str(kind), True))
        out.append((ops, float(rng.uniform(0.5, 20.0))))
    return out


def _run_script(module, script, rng_seed: int) -> tuple:
    clock = _Clock()
    trace = module.StepTrace(clock=clock, capacity=8)
    rng = np.random.default_rng(rng_seed)
    samples = []
    for step, (ops, wall_ms) in enumerate(script):
        t0 = clock.t
        for op, phase, arg in ops:
            clock.t += float(rng.uniform(0.0, 0.004))
            if op == "begin":
                trace.begin()
                continue
            if op == "dispatch":
                scope = trace.dispatch(phase, step)
            elif op == "sync":
                scope = trace.sync(phase, step)
            else:
                scope = trace.drain(phase, anchored=arg)
            with scope:
                clock.t += float(rng.uniform(0.0, 0.006))
        clock.t = max(clock.t, t0 + wall_ms / 1e3)
        samples.append(dataclasses.asdict(trace.commit(wall_ms)))
    totals = (trace.steps, trace.device_ms_total, trace.host_ms_total,
              trace.dispatch_ms_total, dict(trace.device_ms_by_phase),
              trace.host_bound, [dataclasses.asdict(s)
                                 for s in trace.drain_samples()])
    return samples, totals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_steptrace_script_equals_the_reference(seed):
    script = _script(np.random.default_rng(seed), 24)
    mine = _run_script(steptrace, script, seed + 100)
    theirs = _run_script(ref_st, script, seed + 100)
    assert mine == theirs
    samples = mine[0]
    for s in samples:
        assert s["host_ms"] + s["device_ms"] == pytest.approx(s["wall_ms"])


def test_host_bound_flips_after_eight_host_heavy_steps():
    for module in (steptrace, ref_st):
        clock = _Clock()
        trace = module.StepTrace(clock=clock)
        verdicts = []
        for i in range(10):
            trace.begin()
            with trace.dispatch("decode"):
                pass
            with trace.drain("decode"):
                clock.t += 0.001  # 1 ms of device in a 10 ms step
            verdicts.append(trace.commit(10.0).kind)
            assert trace.host_bound == (i >= steptrace.HOST_BOUND_STEPS - 1)
        trace.begin()
        with trace.sync("prefill"):
            clock.t += 0.02
        trace.commit(20.0)
        assert not trace.host_bound
        assert verdicts == ["decode"] * 10


@pytest.mark.parametrize("name", PRESETS)
def test_param_and_kv_bytes_equal_the_reference(name):
    mine, theirs = port_config(name), get_config(name)
    assert timing_model.param_count(mine) == ref_tm.param_count(theirs)
    for nbytes in (1, 2):
        assert (timing_model.kv_bytes_per_token(mine, nbytes)
                == ref_tm.kv_bytes_per_token(theirs, nbytes))


def _ref_spec(spec: chips.ChipSpec) -> ref_chips.ChipSpec:
    return ref_chips.ChipSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("chip", ["h100", "cpu"])
def test_timing_model_equals_the_reference(name, chip):
    spec = chips.get_chip(chip)
    mine = timing_model.TimingModel(port_config(name), spec, mfu=0.4)
    theirs = ref_tm.TimingModel(get_config(name), _ref_spec(spec), mfu=0.4)
    for isl in (1, 128, 2048):
        assert mine.prefill_ttft_ms(isl) == theirs.prefill_ttft_ms(isl)
        assert (mine.prefill_thpt_per_chip(isl)
                == theirs.prefill_thpt_per_chip(isl))
    for batch, ctx in ((1, 128), (16, 2048)):
        assert mine.decode_itl_ms(batch, ctx) == theirs.decode_itl_ms(batch,
                                                                      ctx)
        assert (mine.decode_thpt_per_chip(batch, ctx)
                == theirs.decode_thpt_per_chip(batch, ctx))
    assert mine.max_kv_tokens() == theirs.max_kv_tokens()


def test_the_h100_spec_is_the_data_sheet():
    spec = chips.get_chip("H100")
    assert (spec.bf16_tflops, spec.hbm_gbps) == (989.0, 3350.0)
    assert chips.get_chip("cpu") == chips.CHIPS["cpu"]
    assert dataclasses.asdict(chips.CHIPS["cpu"]) == dataclasses.asdict(
        ref_chips.CHIPS["cpu"])
    with pytest.raises(ValueError, match="unknown chip"):
        chips.get_chip("v5e")
    # no card here: the gauges fall back to the cpu spec
    assert steptrace.detect_chip() == chips.CHIPS["cpu"]


INTERVALS = [dict(prefill_tokens=p, decode_tokens=d, decode_steps=s,
                  active_kv_tokens=kv, device_s=dev)
             for p, d, s, kv, dev in ((0, 16, 16, 4096, 0.2),
                                      (1500, 8, 8, 3000, 0.35),
                                      (64, 0, 0, 0, 0.01),
                                      (0, 128, 64, 20000, 1.3),
                                      (10, 10, 10, 10, 0.0))]


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("chip", ["h100", "cpu"])
@pytest.mark.parametrize("wb,kvb", [(2.0, 2), (0.53125, 1), (1.0, 2)])
def test_live_roofline_equals_the_reference(name, chip, wb, kvb):
    spec = chips.get_chip(chip)
    mine = steptrace.LiveRoofline(port_config(name), chip=spec,
                                  weight_bytes_per_param=wb,
                                  kv_dtype_bytes=kvb)
    theirs = ref_st.LiveRoofline(get_config(name), chip=_ref_spec(spec),
                                 weight_bytes_per_param=wb,
                                 kv_dtype_bytes=kvb)
    for interval in INTERVALS:
        got, want = mine.observe(**interval), theirs.observe(**interval)
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("chip", ["h100", "cpu"])
def test_live_roofline_fraction_is_the_ideal_time_clamped(chip):
    """`ideal_s` is the roofline time `observe`'s fraction divides by the
    measured device time: equal to it below 1, above it once clamped."""
    roof = steptrace.LiveRoofline(port_config("tiny-test"),
                                  chip=chips.get_chip(chip))
    for interval in INTERVALS:
        if interval["device_s"] <= 0:
            continue
        ratio = roof.ideal_s(
            prefill_tokens=interval["prefill_tokens"],
            decode_steps=interval["decode_steps"],
            active_kv_tokens=interval["active_kv_tokens"]
        ) / interval["device_s"]
        _, fraction = roof.observe(**interval)
        assert fraction == pytest.approx(min(1.0, ratio), rel=1e-12)


def test_launch_gate_keeps_launches_and_the_profiler_apart():
    """Launches share the gate; the profiler's exclusive hold waits for the
    launches under way and holds new ones back until it is done."""
    gate = steptrace.LaunchGate()
    order = []
    in_launch, release = threading.Event(), threading.Event()

    def launching(tag, hold):
        with gate.launch():
            order.append(f"{tag}+")
            if hold:
                in_launch.set()
                release.wait(5)
            order.append(f"{tag}-")

    first = threading.Thread(target=launching, args=("a", True))
    first.start()
    assert in_launch.wait(5)
    launching("b", False)  # a second launch does not wait for the first
    held = threading.Event()

    def profiler():
        with gate.exclusive():
            held.set()
            order.append("p+")
            time.sleep(0.05)
            order.append("p-")

    prof = threading.Thread(target=profiler)
    prof.start()
    time.sleep(0.05)
    assert not held.is_set()  # waits for launch a
    release.set()
    first.join(5)
    assert held.wait(5)
    launching("c", False)  # waits for the profiler's hold to end
    prof.join(5)
    assert order == ["a+", "b+", "b-", "a-", "p+", "p-", "c+", "c-"]


def test_measure_device_on_the_host_clock():
    calls = itertools.count()
    out = steptrace.measure_device(lambda: next(calls), steps=4, trials=3,
                                   device="cpu")
    assert next(calls) == 12 and len(out["trials_s"]) == 3
    assert out["median_s"] == sorted(out["trials_s"])[1] >= 0
    with pytest.raises(RuntimeError, match="cuda"):
        steptrace.measure_device(lambda: None)  # no card: no fallback


# -- the scheduler and the worker --------------------------------------------


def _request(rid, tokens, max_tokens, **sampling):
    return protocols.PreprocessedRequest(
        request_id=rid, token_ids=list(tokens),
        sampling=protocols.SamplingOptions(max_tokens=max_tokens,
                                           temperature=0.0, **sampling),
        stop=protocols.StopConditions(ignore_eos=True))


def _serve(sched, requests, timeout=60.0) -> None:
    queues = []
    for req in requests:
        q: thread_queue.Queue = thread_queue.Queue()
        sched.submit(req, q.put)
        queues.append(q)
    for q in queues:
        while q.get(timeout=timeout).finish_reason is None:
            pass


@pytest.fixture(scope="module")
def runner():
    return ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu")


def test_scheduler_steps_split_into_host_and_device(runner, monkeypatch):
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    sched = InferenceScheduler(runner)
    sched.start()
    try:
        # fused blocks (dispatch + drain), a deferred prefill token (the
        # late drain), batched prefill, and a logprobs request (sync scopes)
        _serve(sched, [_request("a", range(3, 30), 12),
                       _request("b", range(40, 50), 9)])
        _serve(sched, [_request("c", range(5, 18), 5, logprobs=1)])
    finally:
        sched.stop()
    samples = sched.steptrace.drain_samples()
    assert len(samples) == sched.stats.steps == sched.steptrace.steps
    phases = set()
    for s in samples:
        assert s.host_ms + s.device_ms == pytest.approx(s.wall_ms, rel=1e-9)
        assert s.device_ms <= s.wall_ms and s.host_ms >= 0
        assert s.prep_ms + s.dispatch_ms <= s.wall_ms + 1e-6
        phases |= set(s.device_by_phase)
    assert phases == {"decode", "prefill"}
    last = sched.steptrace.last
    assert (sched.stats.device_ms_last_step,
            sched.stats.host_ms_last_step) == (last.device_ms, last.host_ms)
    assert sched.stats.last_step_wall_ms == last.wall_ms
    assert sched.steptrace.device_ms_total > 0
    assert sched.active_kv_tokens() == 0  # every slot released


def test_step_split_places_known_delays(runner, monkeypatch):
    """An independent reading of the split: a known delay inside the
    runner's per-token decode (a blocking readback) lands in the device
    window, and one inside a fused block's submit lands in dispatch, on the
    host side."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    delay_ms = 20.0
    calls = []

    def slowed(fn, kind):
        def call(*args, **kwargs):
            time.sleep(delay_ms / 1e3)
            calls.append(kind)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(runner, "decode", slowed(runner.decode, "sync"))
    monkeypatch.setattr(runner, "decode_multi",
                        slowed(runner.decode_multi, "block"))
    sched = InferenceScheduler(runner)
    steps = []
    commit = sched.steptrace.commit

    def committing(wall_ms):
        sample = commit(wall_ms)
        steps.append((sample, list(calls)))
        calls.clear()
        return sample

    sched.steptrace.commit = committing
    sched.start()
    try:
        _serve(sched, [_request("a", range(3, 30), 12)])
        _serve(sched, [_request("c", range(5, 18), 5, logprobs=1)])
    finally:
        sched.stop()
    seen = set()
    for sample, kinds in steps:
        n_sync, n_block = kinds.count("sync"), kinds.count("block")
        seen |= set(kinds)
        if n_sync:
            assert sample.device_by_phase["decode"] >= n_sync * delay_ms
            assert sample.host_ms <= sample.wall_ms - n_sync * delay_ms + 1e-6
        if n_block:
            assert sample.dispatch_ms >= n_block * delay_ms
            assert sample.host_ms >= n_block * delay_ms
    assert seen == {"sync", "block"}


def _sample_count(name: str, labels: str) -> float:
    for line in metrics.render().decode().splitlines():
        if line.startswith(f"{name}_count{{{labels}}}"):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _gauge(name: str, worker: TorchWorker) -> float:
    key = f'{name}{{worker="{worker.instance_id:x}"}}'
    for line in metrics.render().decode().splitlines():
        if line.startswith(key + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{key} not published")


def test_worker_publishes_the_steptrace_metrics(runner):
    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=runner.model)
    worker.start()
    try:
        before = _sample_count("dynamo_step_device_ms", 'phase="decode"')
        worker.publish_steptrace_metrics()  # seeds the interval
        _serve(worker.scheduler, [_request("m", range(7, 27), 16)])
    finally:
        # joined: the step that emitted the finish frame has committed
        worker.close()
    worker.publish_steptrace_metrics()
    assert _sample_count("dynamo_step_device_ms",
                         'phase="decode"') > before
    mfu = _gauge("dynamo_mfu", worker)
    fraction = _gauge("dynamo_roofline_fraction", worker)
    # on the cpu spec: a positive share, a fraction at most 1
    assert mfu > 0 and 0 < fraction <= 1
    assert _gauge("dynamo_host_bound", worker) in (0.0, 1.0)
    m = worker._load_metrics()
    assert m.device_ms_in_step + m.host_ms_in_step == pytest.approx(
        m.step_wall_ms, rel=1e-9)


@pytest.mark.parametrize("name", ["STEP_DEVICE_MS", "STEP_HOST_MS",
                                  "TTFT_DEVICE_MS", "MFU_GAUGE",
                                  "ROOFLINE_FRACTION", "HOST_BOUND"])
def test_metric_families_match_the_reference(name):
    from dynamo_tpu.runtime import metrics as ref_metrics

    mine, theirs = getattr(metrics, name), getattr(ref_metrics, name)
    assert mine.name == theirs._name
    assert mine.doc == theirs._documentation
    assert mine.labelnames == theirs._labelnames
    if hasattr(theirs, "_upper_bounds"):
        assert list(mine.buckets) == list(theirs._upper_bounds)
