"""The port's graceful drain (`engine/drain.py`, the scheduler's drain
sweep, the worker's handoff) against the JAX package's (tiny-test, CPU, all
in this process; 127.0.0.1 only).

The cases of the reference's tests/test_drain.py, on the port:

  * a KV handoff is bit-identical: a sequence drained mid-decode parks its
    computed pages and resume state; a fresh scheduler admits it with the
    pulled pages and continues the stream, and source + destination tokens
    equal the JAX engine's uninterrupted stream exactly (float32, tolerance
    0: token ids), greedy, seeded and with speculation active, with ZERO
    prompt tokens recomputed;
  * the ladder: waiting and logits-processor sequences take the replay rung,
    drain_expire ends what is left with an in-band error, a draining
    scheduler bounces arrivals, the parked pages release exactly once;
  * the coordinator: announce -> sweep -> deadline rung, idempotent under a
    double drain, DYNT_DRAIN_ENABLE=0 and DYNT_DRAIN_HANDOFF=0;
  * dynamo_drain_state walks 0 -> 1 -> 2, the drain metric families are the
    reference's, POST /drain and the request-plane verb run the ladder;
  * end to end behind a port frontend: a bf16 handoff from a port worker to
    a JAX worker and from a JAX worker to a port worker, and an int8 handoff
    between port workers, each resuming with no prompt token recomputed.
"""

import asyncio
import dataclasses
import http.client
import queue as thread_queue
import threading
import time
import uuid

import jax
import pytest

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.llm import protocols as ref_protocols
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu_torch.engine import (
    InferenceScheduler,
    ModelRunner,
    RunnerConfig,
    TorchWorker,
)
from dynamo_tpu_torch.engine import drain
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.llm import protocols as port_protocols
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime import metrics
from dynamo_tpu_torch.runtime.status import SystemStatusServer

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=96, max_batch=2, max_pages_per_seq=36,
              prefill_buckets=(8, 16, 32))
STEP = 60.0


@pytest.fixture(autouse=True)
def _small_decode_block(monkeypatch):
    # A fused block of 8 can finish a short stream before the sweep's
    # between-steps callback lands; 2 keeps every case mid-stream.
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "2")


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _runner(params, **kw):
    return ModelRunner(CFG, RunnerConfig(**{**RUNNER, **kw}), device="cpu",
                       params=params_from_numpy(params, CFG, device="cpu"))


def _request(protocols, tokens, max_tokens, temperature=0.0, seed=7,
             rid=None):
    return protocols.PreprocessedRequest(
        request_id=rid or uuid.uuid4().hex, token_ids=list(tokens),
        sampling=protocols.SamplingOptions(max_tokens=max_tokens,
                                           temperature=temperature,
                                           seed=seed),
        stop=protocols.StopConditions(ignore_eos=True))


class _Stream:
    """Collects one request's outputs off the scheduler thread."""

    def __init__(self) -> None:
        self.queue: thread_queue.Queue = thread_queue.Queue()
        self.outputs: list = []

    def emit(self, out) -> None:
        self.queue.put(out)

    def drain(self, timeout=STEP) -> "_Stream":
        while not self.outputs or self.outputs[-1].finish_reason is None:
            self.outputs.append(self.queue.get(timeout=timeout))
        return self

    def take_tokens(self, n, timeout=STEP) -> "_Stream":
        while len(self.tokens) < n:
            out = self.queue.get(timeout=timeout)
            self.outputs.append(out)
            assert out.finish_reason is None, (out.finish_reason, out.error)
        return self

    @property
    def tokens(self) -> list:
        return [t for o in self.outputs for t in o.token_ids]

    @property
    def finish(self):
        return self.outputs[-1].finish_reason if self.outputs else None


def _in_step(sched, fn):
    result, exc = sched.run_in_step(fn).get(timeout=STEP)
    assert exc is None, exc
    return result


def _gathering_registry(runner, store):
    """register_handoff: the computed pages gathered to the host (what the
    worker's transfer table serves to the peer's pull) and the resume
    state."""

    def register(seq, page_ids, computed):
        store[seq.request.request_id] = runner.gather_pages(page_ids)
        return {"transfer_id": seq.request.request_id,
                "handoff": {"seed": int(seq.seed),
                            "generated": [int(t) for t in seq.generated],
                            "prompt_len": int(seq.prompt_len)}}

    return register


HANDOFF_CASES = {  # case -> (prompt, temperature)
    "greedy": (list(range(16)), 0.0),
    "seeded": (list(range(16)), 0.9),
    "spec": ([5, 6, 7] * 6, 0.0),
}


def _handoff_request(protocols, case: str):
    prompt, temperature = HANDOFF_CASES[case]
    return _request(protocols, prompt, 40, temperature=temperature, seed=123,
                    rid="h")


@pytest.fixture(scope="module")
def jax_streams(params):
    """The JAX engine's uninterrupted stream of each handoff case, one
    runner for all (speculation leaves a stream unchanged, so the spec
    case's stream is its plain decode's)."""
    runner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                     params=params)
    sched = JScheduler(runner)
    sched.start()
    try:
        streams = {}
        for case in HANDOFF_CASES:
            out = []
            done = threading.Event()

            def emit(o, out=out, done=done):
                out.append(o)
                if o.finish_reason is not None:
                    done.set()

            sched.submit(_handoff_request(ref_protocols, case), emit)
            assert done.wait(STEP)
            assert out[-1].finish_reason == "length"
            streams[case] = [t for o in out for t in o.token_ids]
        return streams
    finally:
        sched.stop()


def _drain_and_resume(src_runner, dst_runner, make, tokens_before=3):
    """Decode on the source until mid-stream, sweep, then resume the handoff
    on a fresh destination scheduler. Returns (source scheduler,
    destination scheduler, source tokens, destination stream)."""
    src = InferenceScheduler(src_runner)
    src.start()
    store: dict = {}
    request = make(port_protocols)
    try:
        stream = _Stream()
        src.submit(request, stream.emit)
        stream.take_tokens(tokens_before)
        report = _in_step(src, lambda: src.drain_sweep(
            register_handoff=_gathering_registry(src_runner, store)))
        stream.drain()
        assert stream.finish == "migrate"
        assert report["handoff"] == [request.request_id]
        handoff = stream.outputs[-1].kv_transfer_params["handoff"]
        # every committed token went out before the handoff frame
        assert handoff["generated"] == stream.tokens
    finally:
        src.stop()
    dst = InferenceScheduler(dst_runner)
    dst.start()
    try:
        d_stream = _Stream()
        dst.submit(make(port_protocols), d_stream.emit,
                   onboard_blocks=store[request.request_id],
                   resume_state=handoff)
        d_stream.drain()
    finally:
        dst.stop()
    return src, dst, stream.tokens, d_stream


@pytest.mark.parametrize("case", list(HANDOFF_CASES))
def test_handoff_continues_the_jax_stream(params, jax_streams, case,
                                          monkeypatch):
    if case == "spec":
        monkeypatch.setenv("DYNT_SPEC_ENABLE", "1")
        monkeypatch.setenv("DYNT_SPEC_MIN_EMA", "0")
    want = jax_streams[case]
    src_runner, dst_runner = _runner(params), _runner(params)
    src, dst, src_tokens, d_stream = _drain_and_resume(
        src_runner, dst_runner,
        lambda protocols: _handoff_request(protocols, case),
        tokens_before=4 if case == "spec" else 3)
    assert src.stats.drain_handoff == 1 and dst.stats.drain_resumed == 1
    assert d_stream.finish == "length"
    assert src_tokens + d_stream.tokens == want
    # the destination ran no prefill pass
    assert dst.stats.prefill_tokens == 0
    if case == "spec":
        assert src.spec_enabled and dst.stats.spec_steps > 0


def test_waiting_and_processor_sequences_take_the_replay_rung(params):
    sched = InferenceScheduler(_runner(params))  # max_batch 2
    sched.start()
    try:
        proc = _Stream()
        req = _request(port_protocols, range(10), 24)
        req.sampling.repetition_penalty = 1.3  # host-sampler state
        sched.submit(req, proc.emit)
        proc.take_tokens(2)
        filler, waiting = _Stream(), _Stream()
        sched.submit(_request(port_protocols, range(20, 30), 24),
                     filler.emit)
        sched.submit(_request(port_protocols, range(30, 40), 8),
                     waiting.emit)
        report = _in_step(sched, lambda: sched.drain_sweep(
            register_handoff=_gathering_registry(sched.runner, {})))
        for s in (proc, waiting, filler):
            s.drain()
    finally:
        sched.stop()
    assert proc.finish == "migrate" and waiting.finish == "migrate"
    assert proc.outputs[-1].kv_transfer_params is None
    assert req.request_id in report["replay"]
    assert sched.stats.drain_replayed >= 2


def test_drain_expire_errors_what_remains(params):
    sched = InferenceScheduler(_runner(params))
    sched.start()
    try:
        s1 = _Stream()
        sched.submit(_request(port_protocols, range(10), 64), s1.emit)
        s1.take_tokens(1)
        n = _in_step(sched, lambda: sched.drain_expire(
            "worker drain deadline exceeded"))
        s1.drain()
    finally:
        sched.stop()
    assert n == 1 and s1.finish == "error"
    assert "deadline" in s1.outputs[-1].error
    assert sched.stats.drain_errored == 1


def test_a_draining_scheduler_bounces_arrivals(params):
    sched = InferenceScheduler(_runner(params))
    sched.start()
    try:
        _in_step(sched, lambda: sched.drain_sweep())
        raced = _Stream()
        sched.submit(_request(port_protocols, range(10), 8), raced.emit)
        raced.drain()
    finally:
        sched.stop()
    assert raced.finish == "migrate" and sched.stats.drain_bounced == 1


def test_handoff_pages_release_exactly_once(params):
    sched = InferenceScheduler(_runner(params, max_batch=1, num_pages=64))
    usable0 = sched.pool.free_count() + sched.pool.cached_count()
    sched.start()
    seqs = {}

    def register(seq, page_ids, computed):
        seqs[seq.request.request_id] = seq
        return {"transfer_id": seq.request.request_id,
                "handoff": {"seed": 0, "generated": [],
                            "prompt_len": seq.prompt_len}}

    try:
        s1 = _Stream()
        sched.submit(_request(port_protocols, range(10), 48), s1.emit)
        s1.take_tokens(2)
        report = _in_step(sched,
                          lambda: sched.drain_sweep(register_handoff=register))
        assert len(report["handoff"]) == 1
        s1.drain()
        parked = sched.pool.free_count() + sched.pool.cached_count()
        assert parked < usable0  # the transfer holds the pages
        for seq in seqs.values():
            sched.release_transfer_pages(seq)
        _in_step(sched, lambda: None)  # the release ran before this
    finally:
        sched.stop()
    assert sched.pool.free_count() + sched.pool.cached_count() == usable0


# -- the coordinator, on a stand-in worker -----------------------------------


class _FakeScheduler:
    class _Stats:
        drain_bounced = 0

    def __init__(self, live=1):
        self.stats = self._Stats()
        self.live = live
        self.calls: list = []

    def run_in_step(self, fn):
        q: thread_queue.Queue = thread_queue.Queue()
        try:
            q.put((fn(), None))
        except Exception as exc:  # noqa: BLE001 — as the real queue
            q.put((None, exc))
        return q

    def drain_sweep(self, register_handoff=None):
        self.calls.append("sweep")
        return {"handoff": ["h1"] if register_handoff else [],
                "replay": ["r1"], "pending": []}

    def drain_expire(self, reason):
        self.calls.append("expire")
        n, self.live = self.live, 0
        return n

    def queue_depth(self):
        return (self.live, 0)


class _FakeTransfers:
    def __init__(self, sched, n=1):
        self._sched = sched
        self.n = n

    def __len__(self):
        return self.n

    def expire_all(self):
        self._sched.calls.append("expire_all")
        n, self.n = self.n, 0
        return n


class _FakeWorker:
    instance_id = 0xD12A1

    def __init__(self, live=1, transfers_n=1):
        self.scheduler = _FakeScheduler(live=live)
        self.transfers = _FakeTransfers(self.scheduler, n=transfers_n)
        self.announces = 0

    async def announce_draining(self) -> None:
        self.announces += 1
        self.scheduler.calls.append("announce")

    def register_drain_handoff(self, seq, page_ids, computed):
        return {"transfer_id": "t"}


def test_ladder_order_and_deadline_rung(run):
    worker = _FakeWorker(live=2, transfers_n=3)
    coord = drain.DrainCoordinator(worker, deadline_secs=0.0)
    report = run(coord.drain("test"), timeout=30)
    assert worker.scheduler.calls == ["announce", "sweep", "expire_all",
                                      "expire"]
    assert report["handoff"] == ["h1"] and report["replay"] == ["r1"]
    assert report["errored"] == 2 and report["completed"] is False
    assert coord.state == "drained"


def test_an_empty_worker_completes_without_expiry(run):
    worker = _FakeWorker(live=0, transfers_n=0)
    coord = drain.DrainCoordinator(worker, deadline_secs=5.0)
    report = run(coord.drain("test"), timeout=30)
    assert worker.scheduler.calls == ["announce", "sweep"]
    assert report["errored"] == 0 and report["completed"] is True
    assert report["duration_ms"] < 5000


def test_a_double_drain_runs_one_ladder(run):
    worker = _FakeWorker(live=0, transfers_n=0)
    coord = drain.DrainCoordinator(worker, deadline_secs=5.0)

    async def both():
        return await asyncio.gather(coord.drain("sigterm-1"),
                                    coord.drain("sigterm-2"))

    r1, r2 = run(both(), timeout=30)
    assert r1 is r2 and worker.announces == 1
    assert worker.scheduler.calls.count("sweep") == 1


def test_the_enable_knob_skips(run, monkeypatch):
    monkeypatch.setenv("DYNT_DRAIN_ENABLE", "0")
    worker = _FakeWorker()
    report = run(drain.DrainCoordinator(worker, deadline_secs=5.0).drain(
        "test"), timeout=30)
    assert report.get("skipped") is True and worker.scheduler.calls == []


def test_the_handoff_knob_disables_rung_one(run, monkeypatch):
    monkeypatch.setenv("DYNT_DRAIN_HANDOFF", "0")
    worker = _FakeWorker(live=0, transfers_n=0)
    coord = drain.DrainCoordinator(worker)
    assert coord.deadline_secs == 20.0  # the reference's default
    report = run(coord.drain("test"), timeout=30)
    assert report["handoff"] == []


def test_drain_state_walks_serving_draining_drained():
    def line():
        return [ln for ln in metrics.render().decode().splitlines()
                if ln.startswith('dynamo_drain_state{worker="77b"}')]

    drain.set_drain_state(0x77B, drain.SERVING)
    assert line() == ['dynamo_drain_state{worker="77b"} 0.0']
    drain.set_drain_state(0x77B, drain.DRAINING)
    assert line() == ['dynamo_drain_state{worker="77b"} 1.0']
    drain.set_drain_state(0x77B, drain.DRAINED)
    assert line() == ['dynamo_drain_state{worker="77b"} 2.0']


@pytest.mark.parametrize("name", ["DRAIN_STATE", "DRAIN_SEQUENCES",
                                  "DRAIN_DURATION_MS",
                                  "DISAGG_STREAMED_PAGES"])
def test_metric_families_match_the_reference(name):
    from dynamo_tpu.runtime import metrics as ref_metrics

    mine, theirs = getattr(metrics, name), getattr(ref_metrics, name)
    suffix = "_total" if theirs._type == "counter" else ""
    assert mine.name == theirs._name + suffix
    assert mine.doc == theirs._documentation
    assert mine.labelnames == theirs._labelnames


def test_the_verb_resolves_shutdown_after_an_early_close(run):
    from dynamo_tpu_torch.runtime import signals

    class _Stub:
        async def drain(self, reason="control"):
            return {"completed": True, "reason": reason}

    async def body():
        ev = signals._shutdown_event()
        ev.clear()
        gen = TorchWorker._drain_endpoint(_Stub(), {"shutdown": True})
        report = await gen.__anext__()
        assert report["completed"] is True
        await gen.aclose()  # the caller hangs up after the report
        assert ev.is_set()
        ev.clear()

    run(body(), timeout=30)


def _post(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=b"")
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("enabled", [True, False])
def test_post_drain_runs_the_registered_drain(run, monkeypatch, enabled):
    monkeypatch.setenv("DYNT_DRAIN_HTTP", "1" if enabled else "0")

    async def body():
        srv = SystemStatusServer(port=0, host="127.0.0.1")
        calls = []

        async def drainer():
            calls.append(1)
            return {"handoff": ["x"], "completed": True}

        await srv.start()
        try:
            status, text = await asyncio.to_thread(_post, srv.port,
                                                   "/drain")
            assert status == 404 and b"no drainable" in text or not enabled
            srv.register_drain(drainer)
            status, text = await asyncio.to_thread(_post, srv.port,
                                                   "/drain")
            if enabled:
                assert status == 200 and b'"handoff"' in text
                assert calls == [1]
            else:
                assert status in (404, 405) and calls == []
        finally:
            await srv.close()

    run(body(), timeout=30)


# -- end to end: handoffs behind a port frontend -----------------------------


def _port_config(root) -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="file", discovery_path=str(root),
                         tcp_host="127.0.0.1", lease_ttl_secs=10.0,
                         system_enabled=False)


def _ref_config(root) -> RefRuntimeConfig:
    return RefRuntimeConfig.from_env(
        discovery_backend="file", discovery_path=str(root),
        request_plane="tcp", tcp_host="127.0.0.1", event_plane="mem",
        system_enabled=False)


async def _until(pred, what: str, timeout: float = 30.0) -> None:
    t = time.monotonic()
    while not pred():
        assert time.monotonic() - t < timeout, what
        await asyncio.sleep(0.005)


BF16 = get_config("tiny-test")  # bfloat16
INT8 = dataclasses.replace(CFG, head_dim=128)
E2E_RUNNER = dict(page_size=4, num_pages=96, max_batch=4,
                  max_pages_per_seq=40, prefill_buckets=(8, 16, 32))


async def _handoff_round(tmp_path, make_workers, source: int):
    """Two workers behind a port frontend (round_robin); two streams are
    placed on worker `source` (the other is held out of selection while
    they arrive), then `source` drains: both streams must hand off to the
    other worker and finish with every token, no prompt token recomputed.
    Returns what the checks and the caller need."""
    state: dict = {}
    rts, workers, fe = [], [], None
    try:
        workers, rts = await make_workers(tmp_path)
        prompts = [list(range(3, 20)), list(range(40, 53))]
        for w in workers:
            # warm: a JAX worker compiles each step shape at its first use,
            # and its peer's stream must not finish meanwhile
            protocols = (port_protocols if isinstance(w, TorchWorker)
                         else ref_protocols)
            body = _request(protocols, prompts[0][::-1], 64).to_wire()
            async for _ in w.generate(body):
                pass
        fe = Frontend(rts[0], host="127.0.0.1", port=0)
        await fe.start()
        ids = {w.instance_id for w in workers}
        await _until(lambda: fe.manager.get("tiny-test") is not None and ids
                     <= set(fe.manager.get("tiny-test").router.client
                            .instance_ids()), "both workers listed")
        entry = fe.manager.get("tiny-test")
        engine = entry.engine
        src, dst = workers[source], workers[1 - source]
        got: dict = {0: [], 1: []}

        async def stream(i):
            req = _request(port_protocols, prompts[i], 64, rid=f"s{i}")
            async for out in engine.generate(req):
                assert out.error is None, out.error
                got[i] += out.token_ids
                state.setdefault("finish", {})[i] = out.finish_reason

        entry.router.set_draining(dst.instance_id, True)
        tasks = [asyncio.ensure_future(stream(i)) for i in range(2)]
        await _until(lambda: all(len(got[i]) >= 8 for i in range(2)),
                     "both streams decoding")
        entry.router.set_draining(dst.instance_id, False)
        prefill0 = dst.scheduler.stats.prefill_tokens
        resumed0 = dst.scheduler.stats.drain_resumed
        # Hold the source's scheduler between steps until the sweep is
        # queued behind the hold: its stream is mid-decode at the sweep,
        # however fast it decodes.
        control = src.scheduler._control
        gate = threading.Event()
        src.scheduler.run_in_step(gate.wait)
        await _until(lambda: control.qsize() == 0, "the source held")
        draining = asyncio.ensure_future(src.drain("test"))
        try:
            await _until(lambda: control.qsize() > 0, "the sweep queued")
            # The handoffs are re-dispatched by the frontend, which must
            # have seen the source's draining card by then, or one can go
            # back to the source, bounce and take the replay rung. The
            # settle tick does not cover it here: a JAX source's
            # LoadMetrics go to its own runtime's event plane, so only the
            # card's republish (file discovery, polled every 0.25 s)
            # reaches a port frontend.
            await _until(lambda: src.instance_id
                         not in entry.router.available(),
                         "the frontend saw the source draining")
        finally:
            gate.set()
        report = await draining
        await asyncio.wait_for(asyncio.gather(*tasks), STEP)
        state.update(report=report, got=got, prompts=prompts,
                     dst_prefill=dst.scheduler.stats.prefill_tokens - prefill0,
                     dst_resumed=(dst.scheduler.stats.drain_resumed
                                  - resumed0))
        return state
    finally:
        if fe is not None:
            await fe.close()
        for w in workers:
            await (w.shutdown() if isinstance(w, TorchWorker) else w.close())
        for rt in rts:
            await rt.shutdown()


def _check_round(state):
    report = state["report"]
    assert len(report["handoff"]) == 2 and report["replay"] == []
    assert report["completed"] is True and report["errored"] == 0
    assert all(len(state["got"][i]) == 64 for i in range(2))
    assert state["finish"] == {0: "length", 1: "length"}
    assert state["dst_resumed"] == 2
    assert state["dst_prefill"] == 0  # the handoffs re-prefilled nothing


@pytest.mark.parametrize("source", ["port", "ref"])
def test_bf16_handoff_across_packages(run, tmp_path, source, params):
    bf16_params = jax.device_get(j_init(jax.random.PRNGKey(0), BF16))

    async def make(root):
        port_rt = await DistributedRuntime(_port_config(root)).start()
        ref_rt = await RefRuntime(_ref_config(root)).start()
        port_w = TorchWorker(BF16, RunnerConfig(**E2E_RUNNER), device="cpu",
                             params=params_from_numpy(bf16_params, BF16,
                                                      device="cpu"))
        port_w.start()
        ref_w = TpuWorker(ref_rt, model_name="tiny-test",
                          runner_config=JRunnerConfig(**E2E_RUNNER),
                          warmup=False)

        async def shared():
            return bf16_params, None

        ref_w._resolve_params = shared
        await ref_w.start()
        await port_w.serve(port_rt)
        ws = [port_w, ref_w] if source == "port" else [ref_w, port_w]
        return ws, [port_rt, ref_rt]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNT_DRAIN_ANNOUNCE_SETTLE_SECS", "0.1")
        _check_round(run(_handoff_round(tmp_path, make, 0), timeout=120))


def test_int8_handoff_between_port_workers(run, tmp_path):
    """An int8 pool's handoff moves packed bundles (value bytes, then the
    scale rows over 128 lanes); the destination resumes, and the drained
    stream equals the same request served undrained."""
    int8_params = jax.device_get(j_init(jax.random.PRNGKey(1), INT8))
    shared = params_from_numpy(int8_params, INT8, device="cpu")
    cfg = RunnerConfig(**E2E_RUNNER, kv_dtype="int8")

    async def make(root):
        rt = await DistributedRuntime(_port_config(root)).start()
        ws = [TorchWorker(INT8, cfg, device="cpu", params=shared)
              for _ in range(2)]
        for w in ws:
            w.start()
            await w.serve(rt)
        return ws, [rt]

    state = run(_handoff_round(tmp_path, make, 0), timeout=120)
    _check_round(state)
    # the undrained streams, one request at a time on a fresh scheduler
    sched = InferenceScheduler(ModelRunner(INT8, cfg, device="cpu",
                                           params=shared))
    sched.start()
    try:
        for i, prompt in enumerate(state["prompts"]):
            s = _Stream()
            sched.submit(_request(port_protocols, prompt, 64), s.emit)
            assert s.drain().tokens == state["got"][i], i
    finally:
        sched.stop()
