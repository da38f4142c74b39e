"""The port's flight recorder (`runtime/flight_recorder.py`) and its debug
routes (`runtime/status.py`) against the JAX package's (CPU; 127.0.0.1
only, no process spawned).

  * the same call sequence (starts, stamps, device burn, events, every
    finish status, the contextvar, slow flags, the ring's capacity, a stale
    entry) gives the reference's `snapshot()` exactly, on one fake clock;
  * /debug/requests on the port's status server answers what the
    reference's answers for the same timelines, under every filter and page;
  * /debug/profile writes a Chrome trace that names a phase scope recorded
    on another thread, takes one capture at a time and clamps its duration,
    and runs every capture on one profiler thread, idle ones included;
    the frontend serves both routes only with DYNT_DEBUG_ENDPOINTS;
  * a request served by the port's worker leaves the timeline the JAX
    worker leaves for the same request: the same phases, device keys and
    status, and a prefill-only leg under its own `#prefill` key.
"""

import asyncio
import dataclasses
import http.client
import json
import logging
import threading
import time

import jax
import torch

from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.llm import protocols as ref_protocols
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import flight_recorder as ref_fr
from dynamo_tpu.runtime import logging as ref_logging
from dynamo_tpu.runtime.status import SystemStatusServer as RefStatusServer
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.llm import protocols as port_protocols
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import flight_recorder as fr
from dynamo_tpu_torch.runtime.status import SystemStatusServer

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
# The reference's worker walks a cold-start ladder (not ported) whose
# events land on its first request's timeline.
UNPORTED_EVENTS = ("coldstart_phase", "coldstart_complete")
RUNNER = dict(page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))


class _FakeTime:
    """time.time for the recorders: moves only between calls of the
    sequence, so log records reading the clock shift nothing."""

    def __init__(self) -> None:
        self.t = 1_700_000_000.0

    def __call__(self) -> float:
        return self.t


class _Ticking:
    """Wraps a recorder: every call first advances the fake clock."""

    def __init__(self, rec, clock: _FakeTime) -> None:
        self._rec = rec
        self._clock = clock

    def __getattr__(self, name):
        fn = getattr(self._rec, name)

        def call(*args, **kwargs):
            self._clock.t += 0.125
            if name == "start":
                # a timeline's default start reads the real clock (bound at
                # class definition in both packages): pass the fake one
                kwargs.setdefault("received", self._clock.t)
            return fn(*args, **kwargs)
        return call


def _drive(rec, current_request_id, clock: _FakeTime) -> None:
    """One call sequence over a recorder of either package."""
    rec = _Ticking(rec, clock)
    rec.start("a", model="m1", trace_id="t1", tenant="acme")
    rec.start("a", model="other", tenant="nope")  # enrich only: first wins
    rec.start("b", model="m2", received=1_700_000_000.5)
    rec.start("c", model="m1", tenant="zeta")
    rec.stamp("a", "queued")
    rec.stamp("a", "queued")  # first write wins
    rec.stamp("unknown", "queued")  # never pollutes
    rec.stamp("b", "scheduled", ts=1_700_000_001.0)
    rec.device("a", "prefill", device_ms=12.5, host_ms=1.25)
    rec.device("a", "prefill", device_ms=2.5)
    rec.device("a", "decode", host_ms=3.0)
    rec.event("a", "kv_pull", link="ici", pages=4, duration_ms=1.5)
    token = current_request_id.set("b")
    try:
        rec.stamp(None, "first_token")
        rec.event(None, "retry", endpoint="e", attempt=1)
        rec.device(None, "decode", device_ms=7.0)
    finally:
        current_request_id.reset(token)
    rec.finish("a")
    rec.finish("a", "error")  # the first finish wins
    rec.finish("b", "deadline_exceeded")
    rec.finish("c", "shed")
    for i in range(4):  # past the ring's capacity
        rid = f"r{i}"
        rec.start(rid, model="m3")
        rec.finish(rid, ("ok", "cancelled", "error", "ok")[i])
    # an entry older than the stale window is retired by the next start
    rec.start("old", received=1_600_000_000.0)
    rec.start("d", model="m1")
    rec.stamp("d", "queued")


def test_snapshot_equals_the_reference(monkeypatch, caplog):
    mine = fr.FlightRecorder(capacity=5, slow_ms=300.0)
    theirs = ref_fr.FlightRecorder(capacity=5, slow_ms=300.0)
    with caplog.at_level(logging.WARNING):
        clock = _FakeTime()
        monkeypatch.setattr(time, "time", clock)
        _drive(mine, fr.current_request_id, clock)
        mine_logs = [r.getMessage() for r in caplog.records
                     if r.name.endswith("flight_recorder")]
        clock = _FakeTime()
        monkeypatch.setattr(time, "time", clock)
        _drive(theirs, ref_logging.current_request_id, clock)
    snapshot = mine.snapshot()
    assert snapshot == theirs.snapshot()
    # the dumps: every status but ok / cancelled / shed, and slow ones: a
    # (slow), b (deadline_exceeded), c (a slow shed), r2 (error)
    assert [json.loads(m[m.index("{"):])["request_id"]
            for m in mine_logs] == ["a", "b", "c", "r2"]
    got = json.loads(mine_logs[0][mine_logs[0].index("{"):])
    assert got["status"] == "ok" and got["device"] == {
        "prefill_device_ms": 15.0, "prefill_host_ms": 1.25,
        "decode_host_ms": 3.0}
    inflight = mine.get("d")
    inflight.phases["mutated"] = 1.0  # a copy: the recorder is untouched
    assert "mutated" not in mine.get("d").phases
    # newest first: the stale entry was retired last
    assert [t["status"] for t in mine.snapshot()["completed"]][0] == "stale"


def test_the_process_recorder_reads_its_knobs(monkeypatch):
    monkeypatch.setenv("DYNT_FLIGHT_RECORDER_SIZE", "2")
    monkeypatch.setenv("DYNT_SLOW_TRACE_MS", "1")
    fr.reset_recorder()
    try:
        rec = fr.get_recorder()
        assert rec is fr.get_recorder() and rec.slow_ms == 1.0
        for i in range(3):
            rec.start(f"k{i}")
            rec.finish(f"k{i}")
        assert [t["request_id"] for t in rec.snapshot()["completed"]] == [
            "k2", "k1"]
    finally:
        fr.reset_recorder()


# -- the debug routes --------------------------------------------------------


def _get(port: int, path: str, timeout: float = 30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


QUERIES = ["", "?status=ok", "?status=error", "?tenant=acme", "?model=m1",
           "?slow=1", "?limit=2", "?offset=1&limit=1", "?model=m3&offset=2",
           "?status=inflight", "?limit=x"]


def test_debug_requests_filters_as_the_reference(run, monkeypatch):
    monkeypatch.setenv("DYNT_FLIGHT_RECORDER_SIZE", "5")
    monkeypatch.setenv("DYNT_SLOW_TRACE_MS", "300")
    fr.reset_recorder()
    ref_fr.reset_recorder()
    try:
        for recorder, var in ((fr.get_recorder(), fr.current_request_id),
                              (ref_fr.get_recorder(),
                               ref_logging.current_request_id)):
            clock = _FakeTime()
            monkeypatch.setattr(time, "time", clock)
            _drive(recorder, var, clock)
        # the clock stays still while both servers answer: an inflight
        # timeline's elapsed_ms reads it

        async def go():
            mine = SystemStatusServer(port=0, host="127.0.0.1")
            theirs = RefStatusServer(port=0, host="127.0.0.1")
            await mine.start()
            await theirs.start()
            try:
                out = []
                for q in QUERIES:
                    a = await asyncio.to_thread(_get, mine.port,
                                                "/debug/requests" + q)
                    b = await asyncio.to_thread(_get, theirs.port,
                                                "/debug/requests" + q)
                    out.append((q, a, b))
                return out
            finally:
                await mine.close()
                await theirs.close()

        for q, (s1, b1), (s2, b2) in run(go()):
            assert s1 == s2, q
            assert json.loads(b1) == json.loads(b2), q
    finally:
        fr.reset_recorder()
        ref_fr.reset_recorder()


def test_debug_profile_captures_every_thread(run, monkeypatch, tmp_path):
    monkeypatch.setenv("DYNT_PROF_DIR", str(tmp_path))
    monkeypatch.setenv("DYNT_PROF_MAX_MS", "400")
    stop = threading.Event()

    def scheduler_like():
        from dynamo_tpu_torch.perf.steptrace import annotation

        step = 0
        while not stop.is_set():
            with annotation("decode", step):
                torch.ones(8).sum()
            step += 1
            time.sleep(0.002)

    thread = threading.Thread(target=scheduler_like, daemon=True)
    thread.start()

    async def go():
        server = SystemStatusServer(port=0, host="127.0.0.1")
        await server.start()
        try:
            first, second = await asyncio.gather(
                asyncio.to_thread(_get, server.port,
                                  "/debug/profile?duration_ms=200"),
                asyncio.sleep(0.05, result=None))
            assert second is None
            both = await asyncio.gather(
                asyncio.to_thread(_get, server.port,
                                  "/debug/profile?duration_ms=9000"),
                asyncio.to_thread(_get, server.port,
                                  "/debug/profile?duration_ms=200"))
            bad = await asyncio.to_thread(_get, server.port,
                                          "/debug/profile?duration_ms=x")
            return first, both, bad
        finally:
            await server.close()

    try:
        first, both, bad = run(go())
    finally:
        stop.set()
        thread.join(5)
    status, body = first
    assert status == 200, body
    out = json.loads(body)
    assert out["files"] == ["trace.json"] and out["duration_ms"] == 200.0
    trace = json.loads((tmp_path / out["trace_dir"] / "trace.json")
                       .read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "decode" in names
    statuses = sorted(s for s, _ in both)
    # one capture at a time (the longer one is clamped to the ceiling)
    assert statuses in ([200, 409], [200, 200])
    clamped = [json.loads(b) for s, b in both if s == 200]
    assert all(c["duration_ms"] in (200.0, 400.0) for c in clamped)
    assert bad[0] == 400


def test_debug_profile_runs_every_capture_on_one_thread(run, monkeypatch,
                                                       tmp_path):
    """Start, stop and export of every capture run on one long-lived
    profiler thread, never on the event loop's; idle captures (no thread
    records a scope) write their traces too."""
    from dynamo_tpu_torch.runtime import status

    monkeypatch.setenv("DYNT_PROF_DIR", str(tmp_path))
    threads = []
    capture = status._capture

    def recording(path, seconds):
        threads.append(threading.current_thread())
        return capture(path, seconds)

    monkeypatch.setattr(status, "_capture", recording)

    async def go():
        server = SystemStatusServer(port=0, host="127.0.0.1")
        await server.start()
        try:
            loop_thread = threading.current_thread()
            got = []
            for ms in (1, 50, 1):
                got.append(await asyncio.to_thread(
                    _get, server.port, f"/debug/profile?duration_ms={ms}"))
            return loop_thread, got
        finally:
            await server.close()

    loop_thread, got = run(go())
    assert [s for s, _ in got] == [200, 200, 200], got
    for _, body in got:
        out = json.loads(body)
        assert out["files"] == ["trace.json"]
        assert (tmp_path / out["trace_dir"] / "trace.json").stat().st_size
    assert len(threads) == 3 and len({t.ident for t in threads}) == 1
    assert threads[0] is not loop_thread
    assert threads[0].name.startswith("dynt-profiler")


def test_frontend_serves_the_debug_routes_only_when_asked(run, monkeypatch):
    async def routes(enabled: bool):
        if enabled:
            monkeypatch.setenv("DYNT_DEBUG_ENDPOINTS", "1")
        else:
            monkeypatch.delenv("DYNT_DEBUG_ENDPOINTS", raising=False)
        service = HttpService(None, host="127.0.0.1", port=0)
        await service.start()
        try:
            return [(await asyncio.to_thread(_get, service.port, p))[0]
                    for p in ("/debug/requests",
                              "/debug/profile?duration_ms=x")]
        finally:
            await service.close()

    assert run(routes(False)) == [404, 404]
    assert run(routes(True)) == [200, 400]


# -- timelines of served requests ----------------------------------------------


def _wire(protocols, rid: str, prefill_only: bool = False) -> dict:
    return protocols.PreprocessedRequest(
        request_id=rid, token_ids=list(range(3, 24)),
        sampling=protocols.SamplingOptions(max_tokens=6, temperature=0.0),
        stop=protocols.StopConditions(ignore_eos=True),
        annotations={"prefill_only": True} if prefill_only else {},
    ).to_wire()


def _shape(timeline) -> tuple:
    return (timeline.status, sorted(timeline.phases),
            sorted(timeline.device), [e["event"] for e in timeline.events
                                      if e["event"] not in UNPORTED_EVENTS])


def test_served_timelines_equal_the_reference(run, mem_runtime_config):
    params = jax.device_get(j_init(jax.random.PRNGKey(0), CFG))

    async def go():
        port_w = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                             params=params_from_numpy(params, CFG,
                                                      device="cpu"))
        port_w.start()
        rt = await RefRuntime(mem_runtime_config()).start()
        ref_w = TpuWorker(rt, model_name="tiny-test",
                          runner_config=JRunnerConfig(**RUNNER),
                          warmup=False)
        ref_w.model_config = CFG

        async def shared():
            return params, None

        ref_w._resolve_params = shared
        await ref_w.start()
        out = {}
        try:
            for name, worker, protocols, recorder in (
                    ("port", port_w, port_protocols, fr.get_recorder()),
                    ("ref", ref_w, ref_protocols, ref_fr.get_recorder())):
                for rid, leg in ((f"{name}-dec", False),
                                 (f"{name}-pre", True)):
                    tokens = []
                    async for item in worker.generate(
                            _wire(protocols, rid, leg)):
                        tokens += item.get("t") or []
                    key = f"{rid}#prefill" if leg else rid
                    out[(name, leg)] = (recorder.get(key), tokens)
        finally:
            port_w.close()
            await ref_w.close()
            await rt.shutdown()
        return out

    out = run(go(), timeout=120.0)
    for leg in (False, True):
        (mine, my_tokens), (theirs, their_tokens) = (out[("port", leg)],
                                                     out[("ref", leg)])
        assert mine is not None and theirs is not None
        assert _shape(mine) == _shape(theirs), leg
        assert my_tokens == their_tokens
    timeline = out[("port", False)][0]
    assert timeline.status == "ok" and timeline.phases["finished"] >= (
        timeline.phases["first_token"] >= timeline.phases["prefill_start"]
        >= timeline.phases["scheduled"] >= timeline.phases["queued"]
        >= timeline.phases["received"])
    assert timeline.device["prefill_device_ms"] > 0
