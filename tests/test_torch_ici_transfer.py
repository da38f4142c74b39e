"""The port's co-located disaggregation (`engine/ici_transfer.py`, the
worker's bridge wiring, `--mode comesh`) against the JAX package's
(tiny-test, float32, CPU; all in this process, mem planes, no socket).

  * `split_devices` raises where `split_mesh` raises, with its message, and
    refuses what it does not port (a pool of several devices);
  * a bridged bundle is bit-equal to the reference's `gather_kv_blocks` on
    the same pool, serial and streamed, and its pages go back to the prefill
    pool once; an int8 pool's packed bundle is byte-equal to
    `gather_kv_blocks_q8`, where the reference's bridge degrades to
    recompute (a logged difference);
  * a comesh pair's greedy streams equal the aggregated port worker's and
    the reference's comesh pair's, token for token, serial and streamed;
    every pull takes the `ici` link (its kv_pull event says so) and the
    decode worker prefills nothing;
  * decode goes on while a transfer's gather is held;
  * a drain handoff between comesh decode workers never takes the bridge.
"""

import asyncio
import contextlib
import dataclasses
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine import TpuWorker
from dynamo_tpu.engine import ici_transfer as ref_ici
from dynamo_tpu.llm import protocols as ref_protocols
from dynamo_tpu.llm.engine import RouterEngine as RefRouterEngine
from dynamo_tpu.llm.kv_transfer import PendingTransfer as RefPending
from dynamo_tpu.llm.kv_transfer import PendingTransferTable as RefTable
from dynamo_tpu.llm.prefill_router import PrefillPool as RefPrefillPool
from dynamo_tpu.llm.prefill_router import (
    PrefillRouterEngine as RefPrefillRouterEngine,
)
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.ops.block_copy import gather_kv_blocks, gather_kv_blocks_q8
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime.push_router import PushRouter as RefPushRouter
from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig, TorchWorker
from dynamo_tpu_torch.engine.ici_transfer import IciKvBridge, split_devices
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.llm.engine import RouterEngine
from dynamo_tpu_torch.llm.kv_transfer import (
    KvLayoutDescriptor,
    PendingTransfer,
    StreamingTransfer,
)
from dynamo_tpu_torch.llm.prefill_router import PrefillPool, PrefillRouterEngine
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.flight_recorder import get_recorder
from dynamo_tpu_torch.runtime.push_router import PushRouter

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
INT8 = dataclasses.replace(CFG, head_dim=128)
# a max chunk of 8: a 17-token prompt prefills in 3 chunks
RUNNER = dict(page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(8,))
PROMPTS = (list(range(30, 47)), list(range(60, 75)))  # 17 and 15 tokens
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _port_rt_config() -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="mem",
                         discovery_path=uuid.uuid4().hex,
                         request_plane="mem", event_plane="mem",
                         system_enabled=False, lease_ttl_secs=10.0)


# -- split_devices -------------------------------------------------------------


@pytest.mark.parametrize("p,d", [(8, 8), (5, 4), (1, 8), (0, 9)])
def test_split_devices_raises_where_split_mesh_raises(p, d):
    with pytest.raises(ValueError) as theirs:
        ref_ici.split_mesh(p, d)
    with pytest.raises(ValueError) as mine:
        split_devices(p, d, devices=[torch.device("cuda", i)
                                     for i in range(8)])
    assert str(mine.value) == str(theirs.value)


def test_split_devices_partitions_one_device_a_pool():
    devices = [torch.device("cuda", i) for i in range(8)]
    pre, dec = split_devices(1, 1, devices=devices)
    assert (pre, dec) == ([devices[0]], [devices[1]])
    ref_pre, ref_dec = ref_ici.split_mesh(1, 1)
    assert ({d.id for d in ref_pre.devices.flatten()}
            .isdisjoint({d.id for d in ref_dec.devices.flatten()}))
    # the reference shards a pool over several chips; the port refuses
    ref_ici.split_mesh(2, 2, prefill_tp=2, decode_tp=2)
    for kw in (dict(prefill_devices=2, decode_devices=1),
               dict(prefill_devices=1, decode_devices=1, decode_tp=2)):
        with pytest.raises(ValueError, match="tensor parallelism"):
            split_devices(devices=devices, **kw)
    # no card here: the default device list is empty
    with pytest.raises(ValueError, match=r"needs 2 devices .*have 0"):
        split_devices(1, 1)


# -- the bridge against the reference's gather --------------------------------


def _filled_runner(cfg, kv_dtype="model", seed=0) -> ModelRunner:
    runner = ModelRunner(cfg, RunnerConfig(**RUNNER, kv_dtype=kv_dtype),
                         device="cpu")
    rng = np.random.default_rng(seed)
    if kv_dtype == "int8":
        values, scales = runner.kv_cache
        values.copy_(torch.from_numpy(rng.integers(
            -127, 128, values.shape).astype(np.int8)))
        scales.copy_(torch.from_numpy(rng.uniform(
            0.01, 0.2, scales.shape).astype(np.float32)).to(torch.bfloat16))
    else:
        runner.kv_cache.copy_(torch.from_numpy(rng.standard_normal(
            runner.kv_cache.shape).astype(np.float32)))
    return runner


def _prefill_side(cfg, kv_dtype="model") -> tuple:
    bridge = IciKvBridge()
    worker = TorchWorker(cfg, RunnerConfig(**RUNNER, kv_dtype=kv_dtype),
                         device="cpu", mode="prefill", ici_bridge=bridge)
    filled = _filled_runner(cfg, kv_dtype)
    worker.runner.kv_cache = filled.kv_cache
    worker.scheduler.start()
    return bridge, worker


PAGES = [5, 2, 9, 17, 3, 11, 40, 41, 12]


@pytest.mark.parametrize("mode", ["serial", "streamed"])
def test_bridged_bundle_equals_the_reference_gather(run, mode):
    bridge, worker = _prefill_side(CFG)
    releases = []
    layout = KvLayoutDescriptor.from_wire(worker.runner.kv_layout())
    tid = uuid.uuid4().hex
    decode = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu")
    try:
        if mode == "serial":
            worker.transfers.add(PendingTransfer(
                transfer_id=tid, page_ids=list(PAGES),
                release=lambda: releases.append(1), layout=layout,
                prompt_len=len(PAGES) * RUNNER["page_size"]))
        else:
            stream = StreamingTransfer(
                transfer_id=tid, page_ids=PAGES[:3],
                release=lambda: releases.append(1), layout=layout,
                prompt_len=len(PAGES) * RUNNER["page_size"],
                table=worker.transfers)
            worker.transfers.add(stream)

            def chunks():
                time.sleep(0.05)
                stream.append_pages(PAGES[3:6])
                time.sleep(0.05)
                stream.finish(7, list(PAGES))

            threading.Thread(target=chunks, daemon=True).start()
        timings: dict = {}
        bundle, first = run(bridge.pull(tid, decode, timings=timings))
    finally:
        worker.close()
    pool = jnp.asarray(worker.runner.kv_cache.numpy())
    want = np.asarray(gather_kv_blocks(pool, jnp.asarray(PAGES, jnp.int32)))
    got = bundle.tensor.numpy()
    assert got.shape == want.shape and np.array_equal(
        got.view(np.uint32), want.view(np.uint32))
    assert first == (7 if mode == "streamed" else None)
    assert releases == [1] and len(worker.transfers) == 0
    assert (bridge.pulls, bridge.hits) == (1, 1)
    assert timings["chunks"] == (1 if mode == "serial" else 3)
    # an unknown transfer degrades to recompute and counts as a miss
    assert run(bridge.pull("nope", decode)) == (None, None)
    assert (bridge.pulls, bridge.hits) == (2, 1)


class _GapScheduler:
    """The reference bridge's view of a prefill scheduler: run_in_gap runs
    the callback at once and hands back (result, exception)."""

    @staticmethod
    def run_in_gap(fn):
        import queue

        out = queue.Queue(1)
        try:
            out.put((fn(), None))
        except Exception as exc:  # noqa: BLE001
            out.put((None, exc))
        return out

    run_in_step = run_in_gap


def test_int8_pool_bridges_where_the_reference_recomputes(run):
    bridge, worker = _prefill_side(INT8, kv_dtype="int8")
    layout = KvLayoutDescriptor.from_wire(worker.runner.kv_layout())
    decode = ModelRunner(INT8, RunnerConfig(**RUNNER, kv_dtype="int8"),
                         device="cpu")
    try:
        worker.transfers.add(PendingTransfer(
            transfer_id="q8", page_ids=list(PAGES), release=lambda: None,
            layout=layout, prompt_len=len(PAGES) * RUNNER["page_size"]))
        bundle, _ = run(bridge.pull("q8", decode))
    finally:
        worker.close()
    values, scales = worker.runner.kv_cache
    lanes = scales.float().numpy()[..., None].repeat(128, axis=-1)
    j_values = jnp.asarray(values.numpy())
    j_scales = jnp.asarray(lanes, jnp.bfloat16)
    want = np.asarray(gather_kv_blocks_q8(j_values, j_scales,
                                          jnp.asarray(PAGES, jnp.int32)))
    assert np.array_equal(bundle.tensor.numpy(), want)
    # The reference's bridge gathers with gather_kv_blocks, which takes the
    # int8 pool's (values, scales) pair as one array and fails: the pull
    # degrades to recomputing the prefill.
    ref_bridge = ref_ici.IciKvBridge()
    table = RefTable()
    table.add(RefPending(transfer_id="q8", page_ids=list(PAGES),
                         release=lambda: None, layout=None,
                         prompt_len=len(PAGES) * RUNNER["page_size"]))
    runner = type("R", (), {"kv_cache": (j_values, j_scales),
                            "model_config": CFG})()
    ref_bridge.attach_prefill(type("W", (), {
        "transfers": table, "scheduler": _GapScheduler(),
        "runner": runner})())
    dec_mesh = ref_ici.split_mesh(1, 1)[1]
    assert run(ref_bridge.pull("q8", type("D", (), {"mesh": dec_mesh})())
               ) == (None, None)
    assert (ref_bridge.pulls, ref_bridge.hits) == (1, 0)


# -- comesh pairs, port and reference ------------------------------------------


def _request(protocols_mod, tokens, max_tokens=MAX_TOKENS):
    return protocols_mod.PreprocessedRequest(
        request_id=uuid.uuid4().hex, token_ids=list(tokens),
        sampling=protocols_mod.SamplingOptions(max_tokens=max_tokens,
                                               temperature=0.0, seed=7),
        stop=protocols_mod.StopConditions(ignore_eos=True))


async def _collect(engine, request) -> list:
    toks = []
    async with contextlib.aclosing(engine.generate(request)) as stream:
        async for out in stream:
            assert out.error is None, out.error
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                break
    return toks


@contextlib.asynccontextmanager
async def _port_pair(params, decode_workers: int = 1):
    """A port comesh process: a prefill worker and decode worker(s) sharing
    one bridge, with the pipeline a frontend builds (PrefillRouterEngine
    over round_robin routers)."""
    rt = await DistributedRuntime(_port_rt_config()).start()
    bridge = IciKvBridge()
    shared = params_from_numpy(params, CFG, device="cpu")
    workers = [TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                           params=shared, mode="prefill",
                           component="prefill", ici_bridge=bridge)]
    workers += [TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                            params=shared, mode="decode", ici_bridge=bridge)
                for _ in range(decode_workers)]
    routers = []
    try:
        for w in workers:
            w.start()
            await w.serve(rt)
        for component in ("backend", "prefill"):
            router = PushRouter(rt.namespace("dynamo").component(component)
                                .endpoint("generate").client(),
                                mode="round_robin")
            await router.client.start()
            routers.append(router)
        inner = RouterEngine(routers[0])
        pool = PrefillPool(router=routers[1],
                           instances={workers[0].instance_id})
        yield dict(bridge=bridge, prefill=workers[0], decode=workers[1:],
                   inner=inner,
                   disagg=PrefillRouterEngine(inner, lambda: pool))
    finally:
        for router in routers:
            await router.client.close()
        for w in workers:
            await w.shutdown()
        await rt.shutdown()


def _port_streams(run, params, pipeline: int) -> dict:
    async def go():
        async with _port_pair(params) as pair:
            decode = pair["decode"][0]
            out = {"agg": [], "dis": []}
            for prompt in PROMPTS:
                out["agg"].append(await _collect(
                    pair["inner"], _request(protocols, prompt)))
            prefill0 = decode.scheduler.stats.prefill_tokens
            for prompt in PROMPTS:
                # a cached prompt defeats streaming: both pools start empty
                for w in (pair["prefill"], decode):
                    w.scheduler.run_in_step(w.scheduler.pool.clear).get(
                        timeout=30)
                req = _request(protocols, prompt)
                out["dis"].append(await _collect(pair["disagg"], req))
                timeline = get_recorder().get(req.request_id)
                out.setdefault("links", []).append(
                    [e.get("link") for e in timeline.events
                     if e["event"] == "kv_pull"])
            out["decode_prefilled"] = (decode.scheduler.stats.prefill_tokens
                                       - prefill0)
            out["bridge"] = (pair["bridge"].pulls, pair["bridge"].hits)
            out["pull_links"] = [p["link"] for p in decode.pulls]
            out["streamed"] = (pair["prefill"].scheduler.stats
                               .disagg_streamed_pages)
            await asyncio.sleep(0.05)
            out["parked"] = len(pair["prefill"].transfers)
            return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNT_DISAGG_PIPELINE", str(pipeline))
        return run(go(), timeout=120)


def _ref_streams(run, params, mem_runtime_config) -> list:
    async def go():
        rt = await RefRuntime(mem_runtime_config()).start()
        pre_mesh, dec_mesh = ref_ici.split_mesh(1, 1)
        bridge = ref_ici.IciKvBridge()
        workers = []

        async def shared():
            return params, None

        for mode, component, mesh in (("prefill", "prefill", pre_mesh),
                                      ("decode", "backend", dec_mesh)):
            w = TpuWorker(rt, model_name="tiny-test", component=component,
                          mode=mode, runner_config=JRunnerConfig(**RUNNER),
                          warmup=False, mesh=mesh, ici_bridge=bridge)
            w.model_config = CFG
            w._resolve_params = shared
            await w.start()
            workers.append(w)
        routers = []
        for component in ("backend", "prefill"):
            router = RefPushRouter(rt.namespace("dynamo").component(component)
                                   .endpoint("generate").client(),
                                   mode="round_robin")
            await router.client.start()
            routers.append(router)
        pool = RefPrefillPool(router=routers[1],
                              instances={workers[0].instance_id})
        engine = RefPrefillRouterEngine(RefRouterEngine(routers[0]),
                                        lambda: pool)
        try:
            out = [await _collect(engine, _request(ref_protocols, prompt))
                   for prompt in PROMPTS]
            assert (bridge.pulls, bridge.hits) == (2, 2)
            return out
        finally:
            for router in routers:
                await router.client.close()
            for w in workers:
                await w.close()
            await rt.shutdown()

    return run(go(), timeout=180)


@pytest.fixture(scope="module")
def ref_streams(params):
    import asyncio as _asyncio
    import uuid as _uuid

    from dynamo_tpu.runtime.config import RuntimeConfig as RefRuntimeConfig

    def config():
        cfg = RefRuntimeConfig.from_env()
        cfg.discovery_backend = "mem"
        cfg.discovery_path = _uuid.uuid4().hex
        cfg.request_plane = "mem"
        cfg.event_plane = "mem"
        cfg.system_enabled = False
        cfg.lease_ttl_secs = 10.0
        return cfg

    def run(coro, timeout):
        async def bounded():
            return await _asyncio.wait_for(coro, timeout)
        return _asyncio.run(bounded())

    return _ref_streams(run, params, config)


@pytest.mark.parametrize("pipeline", [0, 1])
def test_comesh_streams_equal_aggregated_and_the_reference(
        run, params, ref_streams, pipeline):
    out = _port_streams(run, params, pipeline)
    assert out["dis"] == out["agg"] == ref_streams
    assert all(len(t) == MAX_TOKENS for t in out["dis"])
    assert out["bridge"] == (len(PROMPTS), len(PROMPTS))
    assert out["pull_links"] == ["ici"] * len(PROMPTS)
    assert out["links"] == [["ici"]] * len(PROMPTS)
    assert out["decode_prefilled"] == 0  # onboarded, never recomputed
    assert out["parked"] == 0  # every transfer claimed and released
    assert (out["streamed"] > 0) == (pipeline == 1)


def test_decode_proceeds_during_transfer(run, params):
    async def go():
        async with _port_pair(params) as pair:
            prefill, decode = pair["prefill"], pair["decode"][0]
            gate, gathering = threading.Event(), threading.Event()
            gather = prefill.runner.gather_pages_device

            def held(ids):
                gathering.set()
                assert gate.wait(30)
                return gather(ids)

            prefill.runner.gather_pages_device = held
            got: list = []

            async def long_stream():
                req = _request(protocols, range(40, 50), max_tokens=48)
                async for out in pair["inner"].generate(req):
                    got.extend(out.token_ids)

            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("DYNT_DECODE_BLOCK", "1")  # a token a step
                long_task = asyncio.ensure_future(long_stream())
                while len(got) < 2:
                    await asyncio.sleep(0.005)
                dis_task = asyncio.ensure_future(_collect(
                    pair["disagg"], _request(protocols, PROMPTS[1])))
                while not gathering.is_set():
                    await asyncio.sleep(0.005)
                # the bridge's gather is held on the prefill scheduler: the
                # decode pool keeps stepping meanwhile
                before = len(got)
                t0 = time.monotonic()
                while len(got) < before + 4 and time.monotonic() - t0 < 30:
                    await asyncio.sleep(0.005)
                advanced = len(got) - before
                gate.set()
                dis = await asyncio.wait_for(dis_task, 60)
                await asyncio.wait_for(long_task, 60)
            return advanced, dis, len(got), pair["bridge"].hits

    advanced, dis, n_long, hits = run(go(), timeout=120)
    assert advanced >= 4
    assert len(dis) == MAX_TOKENS and n_long == 48 and hits == 1


def test_a_drain_handoff_never_takes_the_bridge(run, params):
    """Two decode workers of one comesh process: the first drains with a
    live stream; the handoff's params carry no bridge token, so the second
    pulls over the wire (link dcn) and resumes, and the bridge is never
    asked."""
    async def go():
        async with _port_pair(params, decode_workers=2) as pair:
            a, b = pair["decode"]
            params_seen = []
            register = a.register_drain_handoff

            def recording(*args):
                params_seen.append(register(*args))
                return params_seen[-1]

            a.register_drain_handoff = recording
            req = _request(protocols, PROMPTS[0], max_tokens=40)
            req.request_id = "handoff"
            got: list = []
            # place the stream on a, hold a between steps, then drain it
            stream = a.generate(req.to_wire())
            first = await stream.__anext__()
            got += first.get("t") or []
            gate = threading.Event()
            a.scheduler.run_in_step(gate.wait)
            draining = asyncio.ensure_future(a.drain("test", 10.0))
            await asyncio.sleep(0.3)
            gate.set()
            async for item in stream:
                got += item.get("t") or []
                last = item
            assert last.get("f") == "migrate"
            # the frontend's Migration re-dispatches to a peer: here, b
            resumed = dataclasses.replace(
                req, disaggregated_params=last["kv"])
            async for item in b.generate(resumed.to_wire()):
                got += item.get("t") or []
            report = await draining
            assert report["handoff"] == ["handoff"]
            return (params_seen, [p["link"] for p in b.pulls],
                    (pair["bridge"].pulls, pair["bridge"].hits),
                    b.scheduler.stats.drain_resumed, len(got),
                    pair["prefill"]._transfer_params(
                        "x", a._layout(), 1).get("bridge_token"),
                    pair["bridge"].token)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNT_DRAIN_ANNOUNCE_SETTLE_SECS", "0")
        mp.setenv("DYNT_DECODE_BLOCK", "2")
        (seen, links, bridged, resumed, n, token,
         bridge_token) = run(go(), timeout=120)
    assert len(seen) == 1 and "bridge_token" not in seen[0]
    assert seen[0]["handoff"]["generated"]
    assert links == ["dcn"] and bridged == (0, 0) and resumed == 1
    assert n == 40
    # the same worker's prefill-leg params do carry the token
    assert token == bridge_token
