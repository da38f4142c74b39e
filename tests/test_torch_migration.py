"""The port's Migration against the JAX package's, and migration end to end.

Unit part (the cases of tests/test_migration.py): both packages'
`Migration` run over one scripted FlakyEngine-style inner engine (a
stream that dies, asks to migrate, hands off its KV, or completes, attempt
by attempt) and must yield the same outputs and send the same replayed
requests: the prompt extended by the tokens generated, `max_tokens`
reduced, `prior_output_tokens` set, usage reporting the original prompt
length, failure and cooperative bounds kept apart, the drain-handoff
branch re-dispatching with `disaggregated_params`.

End to end (tiny-test, float32, all in this process): two workers behind
one frontend in round_robin; the worker serving a greedy stream is killed
once it has sent K tokens (its request-plane server drops every connection
without a final frame, its lease is revoked, its scheduler stops). The
stream must finish with all its tokens, and its text must equal the same
scenario run by the reference's frontend over two port workers, and by
the reference's frontend and workers. A deadline watchdog's cancel returns
the sequence's pages. Binds 127.0.0.1 only, spawns no subprocess.
"""

import asyncio
import contextlib
import dataclasses
import http.client
import json
import time

import jax
import pytest

from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.frontend import Frontend as RefFrontend
from dynamo_tpu.llm import engine as ref_engine
from dynamo_tpu.llm import protocols as ref_protocols
from dynamo_tpu.llm.http_service import _error_body as ref_error_body
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu.runtime import push_router as ref_push_router
from dynamo_tpu.runtime import request_plane as ref_request_plane
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.llm import engine as port_engine
from dynamo_tpu_torch.llm import protocols as port_protocols
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime import push_router as port_push_router
from dynamo_tpu_torch.runtime import request_plane as port_request_plane

SIDES = {
    "port": (port_engine, port_protocols, port_request_plane,
             port_push_router),
    "ref": (ref_engine, ref_protocols, ref_request_plane, ref_push_router),
}


class _NoSleepPolicy:
    """A retry policy that records the backoffs asked for and sleeps 0."""

    def __init__(self) -> None:
        self.calls = []

    def next_delay(self, prev):
        self.calls.append(prev)
        return 0.0


def _scripted(side: str, script: list):
    """An inner engine of `side`'s package: attempt i emits script[i]'s
    tokens (one output each, with the raw prompt length), then ends as
    script[i]'s outcome: "fail" (ConnectionLost), "gone"
    (NoInstancesAvailable), "timeout" (asyncio.TimeoutError), "migrate"
    (an in-band cooperative migrate), "handoff" (a migrate frame carrying
    a drain handoff), or "stop" / "length" / "eos-less" (completes)."""
    engine_mod, protocols, request_plane, push_router = SIDES[side]

    class Scripted(engine_mod.TokenEngine):
        def __init__(self) -> None:
            self.seen = []

        async def generate(self, request):
            i = len(self.seen)
            self.seen.append(request)
            tokens, outcome = script[min(i, len(script) - 1)]
            for t in tokens:
                yield protocols.EngineOutput(
                    token_ids=[t], prompt_tokens=len(request.token_ids))
            if outcome == "fail":
                raise request_plane.ConnectionLost("worker died")
            if outcome == "gone":
                raise push_router.NoInstancesAvailable("ns/c/generate")
            if outcome == "timeout":
                raise asyncio.TimeoutError()
            if outcome == "migrate":
                yield protocols.EngineOutput(
                    finish_reason="migrate", error="preempted")
                return
            if outcome == "handoff":
                yield protocols.EngineOutput(
                    finish_reason="migrate", error="draining",
                    kv_transfer_params={"handoff": {"hop": i},
                                        "route": f"src-{i}"})
                return
            yield protocols.EngineOutput(token_ids=[999],
                                         finish_reason=outcome)

    return Scripted()


def _request(side: str, max_tokens: int, deadline=None):
    protocols = SIDES[side][1]
    return protocols.PreprocessedRequest(
        request_id="r1", token_ids=[1, 2, 3],
        sampling=protocols.SamplingOptions(max_tokens=max_tokens),
        stop=protocols.StopConditions(), annotations={"tenant_tag": "x"},
        priority="batch", tenant="acme", deadline=deadline)


def _view(outputs) -> list:
    return [(o.token_ids, o.finish_reason, o.error, o.prompt_tokens)
            for o in outputs]


def _seen(requests) -> list:
    return [(r.token_ids, r.prior_output_tokens, r.sampling.max_tokens,
             r.disaggregated_params, r.priority, r.tenant)
            for r in requests]


async def _migrate(side: str, script, max_tokens=10, **kw):
    inner = _scripted(side, script)
    migration = SIDES[side][0].Migration(inner, **kw)
    policy = _NoSleepPolicy()
    migration.policy = policy
    outs = [o async for o in migration.generate(_request(side, max_tokens))]
    return _view(outs), _seen(inner.seen), policy.calls


def _named(name: str):
    script, kw = SCRIPTS[name]
    return _migrate("port", script, **kw)


SCRIPTS = {
    "resume": ([([100, 101, 102], "fail"), ([200, 201, 202], "stop")],
               dict(migration_limit=3)),
    "limit": ([([100, 101, 102], "fail")], dict(migration_limit=2)),
    "in_band_migrate": ([([7], "migrate"), ([8], "stop")],
                        dict(migration_limit=3)),
    "length_during_retries": ([([1, 2, 3, 4, 5], "fail")],
                              dict(migration_limit=5)),
    "gone_then_served": ([([], "gone"), ([], "gone"), ([5, 6], "length")],
                         dict(migration_limit=3)),
    "timeout_then_served": ([([4], "timeout"), ([5], "stop")],
                            dict(migration_limit=1)),
    "coop_separate_bound": ([([1], "migrate"), ([2], "migrate"),
                             ([3], "migrate"), ([4], "stop")],
                            dict(migration_limit=1, cooperative_limit=5)),
    "coop_then_failure": ([([1], "migrate"), ([2], "migrate"), ([3], "fail"),
                           ([4], "stop")],
                          dict(migration_limit=1, cooperative_limit=5)),
    "coop_limit": ([([1], "migrate")],
                   dict(migration_limit=3, cooperative_limit=2)),
    "coop_preserves_tokens": ([([1], "migrate"), ([2], "stop")],
                              dict(migration_limit=0, cooperative_limit=3)),
    "handoff": ([([10, 11], "handoff"), ([12], "handoff"), ([13], "stop")],
                dict(migration_limit=0, cooperative_limit=0)),
    "handoff_then_failed_hop": ([([10], "handoff"), ([11], "migrate"),
                                 ([12], "fail"), ([13], "stop")],
                                dict(migration_limit=1, cooperative_limit=1)),
    "no_failure_budget": ([([100], "fail")], dict(migration_limit=0)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_migration_equals_the_reference(run, name):
    script, kw = SCRIPTS[name]
    mine = run(_migrate("port", script, max_tokens=10, **kw))
    theirs = run(_migrate("ref", script, max_tokens=10, **kw))
    assert mine == theirs
    outputs, seen, backoffs = mine
    # the migrate marker never reaches the client
    assert all(reason != "migrate" for _, reason, _, _ in outputs)
    tokens = [t for ids, _, _, _ in outputs for t in ids]
    assert len(tokens) <= 10
    for req in seen[1:]:
        # replays keep the request's class and tenant
        assert req[4:] == ("batch", "acme")


def test_replay_carries_the_generated_tokens(run):
    outputs, seen, backoffs = run(_named("resume"))
    assert [t for ids, _, _, _ in outputs for t in ids] == [
        100, 101, 102, 200, 201, 202, 999]
    assert seen[1][:3] == ([1, 2, 3, 100, 101, 102], [100, 101, 102], 7)
    # usage: the replay's 6-token prompt is reported as the original 3
    assert {p for _, _, _, p in outputs if p is not None} == {3}
    assert backoffs == [None]


def test_limits_and_outcomes(run):
    outputs, seen, _ = run(_named("limit"))
    assert outputs[-1][1] == "error" and "migration limit" in outputs[-1][2]
    assert len(seen) == 3
    outputs, _, _ = run(_named("length_during_retries"))
    assert outputs[-1][1] == "length"
    outputs, seen, backoffs = run(_named("coop_limit"))
    assert outputs[-1][1] == "error" and len(seen) == 3 and backoffs == []
    outputs, seen, backoffs = run(_named("coop_then_failure"))
    assert outputs[-1][1] == "stop" and len(seen) == 4
    assert backoffs == [None]  # only the failure replay backed off


def test_handoff_redispatches_with_the_pull_route(run):
    outputs, seen, backoffs = run(_named("handoff"))
    assert outputs[-1][1] == "stop" and backoffs == []
    # the same prompt, the pull route as disaggregated_params, no budget
    assert [s[0] for s in seen] == [[1, 2, 3]] * 3
    assert [s[3] for s in seen] == [
        None, {"handoff": {"hop": 0}, "route": "src-0"},
        {"handoff": {"hop": 1}, "route": "src-1"}]
    _, seen, _ = run(_named("handoff_then_failed_hop"))
    # the plain migrate replays the tokens and drops the stale pull route
    assert seen[2][0] == [1, 2, 3, 10, 11] and seen[2][3] is None


@pytest.mark.parametrize("knob,limit,script,attempts", [
    ("DYNT_MIGRATION_LIMIT", "1", [([1], "fail")], 2),
    ("DYNT_PREEMPT_MIGRATION_LIMIT", "1", [([1], "migrate")], 2),
])
def test_limits_honor_the_knobs(run, monkeypatch, knob, limit, script,
                                attempts):
    monkeypatch.setenv(knob, limit)
    from dynamo_tpu_torch.config import env

    for side in ("port", "ref"):
        kw = ({"migration_limit": env("DYNT_MIGRATION_LIMIT")}
              if knob == "DYNT_MIGRATION_LIMIT" else {"migration_limit": 3})
        outputs, seen, _ = run(_migrate(side, script, max_tokens=50, **kw))
        assert outputs[-1][1] == "error" and len(seen) == attempts, side


def test_backoff_is_bounded_by_the_deadline(run):
    """A failure replay sleeps the policy's delay clamped to what is left
    of the deadline, and a spent deadline ends the replays."""
    from dynamo_tpu_torch.runtime.resilience import Deadline

    class Slow:
        def next_delay(self, prev):
            return 30.0

    async def body():
        inner = _scripted("port", [([1], "fail")])
        migration = port_engine.Migration(inner, migration_limit=100)
        migration.policy = Slow()
        start = time.monotonic()
        outs = [o async for o in migration.generate(
            _request("port", 50, deadline=Deadline(0.3)))]
        return outs, time.monotonic() - start, len(inner.seen)

    outs, elapsed, attempts = run(body())
    assert outs[-1].finish_reason == "error"
    assert "deadline exceeded during migration" in outs[-1].error
    assert elapsed < 5.0 and attempts == 2


# -- end to end ---------------------------------------------------------------


CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=128, max_batch=4, max_pages_per_seq=32,
              prefill_buckets=(8, 16, 32))
MODEL = "tiny-test"
PROMPT = [5, 17, 42, 9, 33, 8, 120, 77, 64, 3]
MAX_TOKENS = 24
CUT = 7  # tokens the killed worker sends before it dies


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _port_cfg(root) -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="file", discovery_path=str(root),
                         tcp_host="127.0.0.1", system_enabled=False)


def _ref_cfg(root) -> RefRuntimeConfig:
    return RefRuntimeConfig.from_env(
        discovery_backend="file", discovery_path=str(root),
        request_plane="tcp", tcp_host="127.0.0.1", event_plane="mem",
        system_enabled=False)


async def _kill(rt, stop_scheduler) -> None:
    """A hard failure: the request-plane server drops every connection with
    no final frame, the lease is revoked (no keep-alive re-grants it), the
    scheduler stops."""
    rt._keepalive_task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await rt._keepalive_task
    await rt.request_server.close()
    await rt.discovery.revoke_lease(rt.lease)
    stop_scheduler()


def _cutting(generate, state: dict, kill):
    """Wrap a worker's generate: once it has sent CUT tokens of the first
    stream to reach that many, kill the worker and go silent."""

    async def gen(body, ctx=None):
        sent = 0
        async with contextlib.aclosing(generate(body, ctx)) as stream:
            async for item in stream:
                yield item
                sent += len(item.get("t") or [])
                if state["armed"] and sent >= CUT:
                    state["armed"] = False
                    state["killed_at"] = sent
                    asyncio.ensure_future(kill())
                    await asyncio.Event().wait()
    return gen


def _stream(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps({
            "model": MODEL, "prompt": PROMPT, "max_tokens": MAX_TOKENS,
            "temperature": 0.0, "ignore_eos": True, "stream": True,
            "stream_options": {"include_usage": True}}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        text, finish, usage, errors = "", None, None, []
        for line in resp.read().decode().splitlines():
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            if "error" in chunk:
                errors.append(chunk)
                continue
            if chunk.get("usage"):
                usage = chunk["usage"]
            for choice in chunk.get("choices", []):
                text += choice.get("text") or ""
                finish = choice.get("finish_reason") or finish
        return {"text": text, "finish": finish, "usage": usage,
                "errors": errors}
    finally:
        conn.close()


async def _scenario(params, root, frontend: str, workers: str,
                    monkeypatch) -> dict:
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "1")
    state = {"armed": True}
    rts, ws = [], []
    fe = None
    try:
        for k in range(2):
            if workers == "port":
                rt = await DistributedRuntime(_port_cfg(root)).start()
                w = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                                params=params_from_numpy(params, CFG,
                                                         device="cpu"))
                w.start()
                w.generate = _cutting(
                    w.generate, state,
                    lambda rt=rt, w=w: _kill(rt, w.scheduler.stop))
                await w.serve(rt)
            else:
                rt = await RefRuntime(_ref_cfg(root)).start()
                w = TpuWorker(rt, model_name=MODEL,
                              runner_config=JRunnerConfig(**RUNNER))
                w.model_config = CFG

                async def shared_params():
                    return params, None

                w._resolve_params = shared_params
                w.generate = _cutting(
                    w.generate, state,
                    lambda rt=rt, w=w: _kill(rt, w.scheduler.stop))
                await w.start()
            rts.append(rt)
            ws.append(w)
        if frontend == "port":
            frt = await DistributedRuntime(_port_cfg(root)).start()
            fe = Frontend(frt, host="127.0.0.1", port=0)
        else:
            frt = await RefRuntime(_ref_cfg(root)).start()
            fe = RefFrontend(frt, host="127.0.0.1", port=0)
        rts.append(frt)
        await fe.start()
        while (fe.manager.get(MODEL) is None
               or len(fe.manager.get(MODEL).instances) < 2):
            await asyncio.sleep(0.05)
        out = await asyncio.to_thread(_stream, fe.port)
        out["killed_at"] = state.get("killed_at")
        return out
    finally:
        if fe is not None:
            await fe.close()
        for w in ws:
            with contextlib.suppress(Exception):
                if workers == "port":
                    w.close()
                else:
                    await w.close()
        for rt in rts:
            with contextlib.suppress(Exception):
                await rt.shutdown()


def test_killed_worker_stream_finishes_as_the_reference(params, run,
                                                        tmp_path,
                                                        monkeypatch):
    """The stream survives its worker's death with every token, and its
    text equals the reference frontend's over port workers and over
    reference workers, each killed at the same token."""
    outs = {}
    for frontend, workers in (("port", "port"), ("ref", "port"),
                              ("ref", "ref")):
        outs[(frontend, workers)] = run(_scenario(
            params, tmp_path / f"{frontend}-{workers}", frontend, workers,
            monkeypatch), timeout=120)
    for key, out in outs.items():
        assert out["killed_at"] == CUT, key
        assert out["errors"] == [] and out["finish"] == "length", key
        assert out["usage"]["completion_tokens"] == MAX_TOKENS, key
        assert out["usage"]["prompt_tokens"] == len(PROMPT), key
    texts = {out["text"] for out in outs.values()}
    assert len(texts) == 1, outs


def _reclaimable(pool) -> int:
    """Free pages plus prefix-cache pages no sequence pins."""
    return pool.free_count() + sum(1 for h in pool._cached
                                   if pool._refcount.get(h, 0) == 0)


def test_deadline_cancel_frees_the_sequence_pages(params, run, tmp_path,
                                                  monkeypatch):
    """A request whose x-dynt-deadline-ms runs out mid-generation ends
    with the reference's in-band 504, and the worker's watchdog cancel
    returns its pages to the pool within one scheduler iteration."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "1")

    async def body():
        rt = await DistributedRuntime(_port_cfg(tmp_path)).start()
        frt = await DistributedRuntime(_port_cfg(tmp_path)).start()
        w = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                        params=params_from_numpy(params, CFG, device="cpu"))
        decode = w.runner.decode

        def slow_decode(*args, **kwargs):
            time.sleep(0.02)  # ~50 tokens a second
            return decode(*args, **kwargs)

        w.runner.decode = slow_decode
        w.start()
        fe = Frontend(frt, host="127.0.0.1", port=0)
        try:
            await w.serve(rt)
            await fe.start()
            while fe.manager.get(MODEL) is None:
                await asyncio.sleep(0.05)
            pool = w.scheduler.pool
            free_before = _reclaimable(pool)

            def go():
                conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                                  timeout=30)
                try:
                    conn.request("POST", "/v1/completions", body=json.dumps({
                        "model": MODEL, "prompt": PROMPT,
                        "max_tokens": 100, "temperature": 0.0,
                        "ignore_eos": True, "stream": True}),
                        headers={"Content-Type": "application/json",
                                 "x-dynt-deadline-ms": "400"})
                    resp = conn.getresponse()
                    return resp.read().decode(), time.monotonic()
                finally:
                    conn.close()

            start = time.monotonic()
            text, ended = await asyncio.to_thread(go)
            while (w.scheduler.queue_depth() != (0, 0)
                   and time.monotonic() - ended < 2.0):
                await asyncio.sleep(0.005)
            freed = time.monotonic()
            return (text, ended - start, freed - ended, free_before,
                    _reclaimable(pool))
        finally:
            await fe.close()
            await w.shutdown()
            await frt.shutdown()
            await rt.shutdown()

    text, took, free_lag, before, after = run(body(), timeout=60)
    events = [json.loads(line[6:]) for line in text.splitlines()
              if line.startswith("data: ") and line != "data: [DONE]"]
    errors = [e for e in events if "error" in e]
    assert len(errors) == 1 and errors[0]["error"]["code"] == 504
    assert errors[0] == ref_error_body(504, errors[0]["error"]["message"],
                                       "deadline_exceeded")
    assert "deadline" in errors[0]["error"]["message"]
    assert 0.3 < took < 5.0
    assert free_lag < 0.5
    assert after == before
