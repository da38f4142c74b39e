"""The port's canary health checks against the JAX package's.

`dynamo_tpu_torch/runtime/health_check.py` and the canary support of the
component, status server and worker, held against the reference's (the
cases of tests/test_health_check.py): each scenario runs on both packages'
runtimes and HealthCheckManagers and must give the same probes, health
verdicts, deregistrations and re-registrations. Also: a canary does not
reset the idle clock, a wedged handler times out, /health answers 503 for
a failing endpoint, and the worker's canary payload is the reference
worker's and is answered with one greedy token. Binds 127.0.0.1 only,
spawns no subprocess.
"""

import asyncio
import dataclasses
import http.client
import json
import uuid

import pytest

from dynamo_tpu.llm.protocols import PreprocessedRequest as RefRequest
from dynamo_tpu.llm.protocols import SamplingOptions as RefSampling
from dynamo_tpu.llm.protocols import StopConditions as RefStop
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import HealthCheckManager as RefHealthCheckManager
from dynamo_tpu.runtime import PushRouter as RefPushRouter
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.models import get_config
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    HealthCheckManager,
    RuntimeConfig,
)
from dynamo_tpu_torch.runtime.push_router import PushRouter


def _runtime(side: str, system: bool = False):
    cluster = uuid.uuid4().hex
    if side == "port":
        return DistributedRuntime(RuntimeConfig(
            discovery_backend="mem", discovery_path=cluster,
            tcp_host="127.0.0.1", event_plane="mem", system_enabled=system))
    cfg = RefRuntimeConfig.from_env()
    cfg.discovery_backend = "mem"
    cfg.discovery_path = cluster
    cfg.request_plane = "tcp"
    cfg.tcp_host = "127.0.0.1"
    cfg.event_plane = "mem"
    cfg.system_enabled = system
    return RefRuntime(cfg)


def _manager(side: str, rt, **kw):
    cls = HealthCheckManager if side == "port" else RefHealthCheckManager
    return cls(rt, **kw)


async def _gone(client) -> None:
    deadline = asyncio.get_running_loop().time() + 5.0
    while client.instance_ids():
        assert asyncio.get_running_loop().time() < deadline
        await asyncio.sleep(0.05)


async def _idle_probe(side: str) -> dict:
    rt = await _runtime(side).start()
    try:
        seen = []

        async def handler(req, ctx):
            seen.append(req)
            yield {"ok": True}

        ep = rt.namespace("t").component("w").endpoint("generate")
        served = await ep.serve_endpoint(
            handler, health_check_payload={"canary": True})
        idle_since = served.last_activity
        await _manager(side, rt, canary_wait_time=0.0,
                       canary_timeout=2.0).check_now()
        return {"seen": seen, "healthy": served.healthy(),
                # a canary is not traffic: the idle clock stands
                "idle_clock_kept": served.last_activity == idle_since}
    finally:
        await rt.shutdown()


async def _active_not_probed(side: str) -> dict:
    rt = await _runtime(side).start()
    try:
        seen = []

        async def handler(req, ctx):
            seen.append(req)
            yield {"ok": True}

        ep = rt.namespace("t").component("w").endpoint("generate")
        await ep.serve_endpoint(handler,
                                health_check_payload={"canary": True})
        client = ep.client()
        await client.wait_for_instances(1, timeout=5.0)
        router = (PushRouter if side == "port" else RefPushRouter)(
            client, mode="round_robin")
        out = [x async for x in router.generate({"real": 1})]
        await _manager(side, rt, canary_wait_time=60.0).check_now()
        return {"out": out, "seen": seen}
    finally:
        await rt.shutdown()


async def _failing_deregisters(side: str, wedge: str) -> dict:
    rt = await _runtime(side).start()
    try:
        async def handler(req, ctx):
            if wedge == "raise":
                raise RuntimeError("wedged")
            await asyncio.sleep(30.0)  # a live process, a stuck handler
            yield {"never": True}

        ep = rt.namespace("t").component("w").endpoint("generate")
        served = await ep.serve_endpoint(
            handler, health_check_payload={"canary": True})
        client = ep.client()
        await client.wait_for_instances(1, timeout=5.0)
        manager = _manager(side, rt, canary_wait_time=0.0,
                           canary_timeout=0.3, max_failures=2)
        verdicts = []
        await manager.check_now()
        verdicts.append((served.healthy(), client.instance_ids() != []))
        await manager.check_now()
        await _gone(client)
        verdicts.append((served.healthy(), client.instance_ids() != []))
        return {"verdicts": verdicts}
    finally:
        await rt.shutdown()


async def _recovers(side: str) -> dict:
    rt = await _runtime(side).start()
    try:
        wedged = {"on": True}

        async def handler(req, ctx):
            if wedged["on"]:
                raise RuntimeError("saturated")
            yield {"ok": True}

        ep = rt.namespace("t").component("w").endpoint("generate")
        served = await ep.serve_endpoint(
            handler, health_check_payload={"canary": True})
        client = ep.client()
        await client.wait_for_instances(1, timeout=5.0)
        manager = _manager(side, rt, canary_wait_time=0.0,
                           canary_timeout=2.0, max_failures=1)
        await manager.check_now()
        await _gone(client)
        down = served.healthy()
        wedged["on"] = False
        await manager.check_now()
        await client.wait_for_instances(1, timeout=5.0)
        return {"down": down, "up": served.healthy(),
                "listed": client.instance_ids()}
    finally:
        await rt.shutdown()


def test_canary_probes_idle_endpoint(run):
    mine, theirs = run(_idle_probe("port")), run(_idle_probe("ref"))
    assert mine == theirs == {"seen": [{"canary": True}], "healthy": True,
                              "idle_clock_kept": True}


def test_active_endpoint_not_probed(run):
    mine, theirs = (run(_active_not_probed("port")),
                    run(_active_not_probed("ref")))
    assert mine == theirs == {"out": [{"ok": True}], "seen": [{"real": 1}]}


@pytest.mark.parametrize("wedge", ["raise", "hang"])
def test_failing_canary_marks_unhealthy_and_deregisters(run, wedge):
    mine = run(_failing_deregisters("port", wedge))
    theirs = run(_failing_deregisters("ref", wedge))
    assert mine == theirs == {"verdicts": [(False, True), (False, False)]}


def test_recovered_endpoint_reregisters(run):
    mine, theirs = run(_recovers("port")), run(_recovers("ref"))
    assert mine["down"] is theirs["down"] is False
    assert mine["up"] is theirs["up"] is True
    assert len(mine["listed"]) == len(theirs["listed"]) == 1


def test_health_route_answers_503_while_canaries_fail(run):
    async def body():
        rt = await _runtime("port", system=True).start()
        try:
            state = {"fail": True}

            async def handler(req, ctx):
                if state["fail"]:
                    raise RuntimeError("wedged")
                yield {"ok": True}

            ep = rt.namespace("t").component("w").endpoint("generate")
            await ep.serve_endpoint(handler,
                                    health_check_payload={"canary": True})
            manager = HealthCheckManager(rt, canary_wait_time=0.0,
                                         canary_timeout=2.0, max_failures=5)

            def health():
                conn = http.client.HTTPConnection(
                    "127.0.0.1", rt.status_server.port, timeout=10)
                try:
                    conn.request("GET", "/health")
                    resp = conn.getresponse()
                    return resp.status, json.loads(resp.read())
                finally:
                    conn.close()

            out = [await asyncio.to_thread(health)]
            await manager.check_now()
            out.append(await asyncio.to_thread(health))
            state["fail"] = False
            await manager.check_now()
            out.append(await asyncio.to_thread(health))
            return out
        finally:
            await rt.shutdown()

    (s0, b0), (s1, b1), (s2, b2) = run(body())
    assert (s0, s1, s2) == (200, 503, 200)
    assert b1 == {"status": "unhealthy", "endpoints": {"t/w/generate": False}}
    assert b0 == b2 == {"status": "healthy",
                        "endpoints": {"t/w/generate": True}}


def test_health_manager_loop_starts_and_closes(run):
    async def body():
        rt = await _runtime("port").start()
        try:
            seen = []

            async def handler(req, ctx):
                seen.append(req)
                yield {"ok": True}

            ep = rt.namespace("t").component("w").endpoint("generate")
            await ep.serve_endpoint(handler,
                                    health_check_payload={"canary": True})
            manager = HealthCheckManager(rt, canary_wait_time=0.0,
                                         check_interval=0.05)
            manager.start()
            while len(seen) < 2:
                await asyncio.sleep(0.02)
            await manager.close()
            n = len(seen)
            await asyncio.sleep(0.15)
            return n, len(seen)
        finally:
            await rt.shutdown()

    before, after = run(body())
    assert before == after >= 2


def test_worker_canary_is_the_reference_payload_and_is_answered(run):
    """TorchWorker serves generate with the reference worker's canary
    (`TpuWorker.serve`: one greedy token of token 0, annotated canary);
    a sweep probes it through the request plane and gets its token."""
    ref_canary = RefRequest(
        request_id="_canary", token_ids=[0],
        sampling=RefSampling(max_tokens=1, temperature=0.0),
        stop=RefStop(), annotations={"canary": True}).to_wire()
    cfg = dataclasses.replace(get_config("tiny-test"), dtype="float32")

    async def body():
        rt = await _runtime("port").start()
        worker = TorchWorker(cfg, RunnerConfig(
            page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
            prefill_buckets=(8, 16)), device="cpu")
        worker.start()
        try:
            await worker.serve(rt)
            served = next(s for s in worker._served
                          if s.endpoint.name == "generate")
            others = [s.health_check_payload for s in worker._served
                      if s is not served]
            answers = []
            call = rt.request_client.call
            outs = []

            def recording(*args, **kw):
                stream = call(*args, **kw)

                async def gen():
                    async for item in stream:
                        outs.append(item)
                        yield item
                answers.append(args[3])
                return gen()

            rt.request_client.call = recording
            await HealthCheckManager(rt, canary_wait_time=0.0,
                                     canary_timeout=10.0).check_now()
            return (served.health_check_payload, others, answers, outs,
                    served.healthy())
        finally:
            await worker.shutdown()
            await rt.shutdown()

    payload, others, headers, outs, healthy = run(body())
    assert payload == ref_canary
    # clear_kv_blocks, kv_blocks, kv_pull, drain and weights carry no canary
    assert others == [None, None, None, None, None]
    assert headers == [{"x-dynt-canary": "1"}]
    assert len(outs[0]["t"]) == 1 and healthy
