"""KV-aware routing end to end on tiny-test (float32, CPU), against the JAX
package where the two meet:

  * the port's scheduler and the reference's InferenceScheduler, given the
    same requests, emit the same RouterEvent sequence (stored chains with
    their parents, evictions) and the same local-indexer dump;
  * two port workers behind the port's frontend in kv mode, over file
    discovery, the TCP request plane and the default (zmq) event plane:
    the worker's `kv_blocks` endpoint answers its local index, two
    prefixes land on the two workers by load, a shared-prefix request lands
    on the worker that holds the prefix, the router's tree equals each worker's local index,
    and clear_kv_blocks empties that worker's part of it;
  * p2c routing and busy-threshold shedding (503) on the same workers;
  * the cross-package kv pairings over the journal plane in tmp_path: the
    port's frontend with the reference's worker, and the reference's
    frontend with the port's worker; each router scores the other package's
    cached prefix;
  * draining: reference workers announcing their departure (card flag,
    LoadMetrics) leave the port's kv frontend as they leave the
    reference's, and a card the port does not serve stays ignored.

Binds 127.0.0.1 only, spawns no subprocess; inputs from numpy seeds."""

import asyncio
import dataclasses
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import KvEventBuffer as RefEventBuffer
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.frontend import Frontend as RefFrontend
from dynamo_tpu.llm.http_service import HttpService as RefHttpService
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
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
from dynamo_tpu_torch.engine.worker import KvEventBuffer
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.kv_router import WorkerWithDpRank
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.admission import QueueWaitEstimator
from dynamo_tpu_torch.tokens import compute_block_hashes

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=24, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
SERVE_RUNNER = dict(RUNNER, num_pages=64)
MODEL = "tiny-test"
STEP = 30.0  # bound on any one await


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


# -- the scheduler's events against the reference's --------------------------


def _serve(scheduler, requests, timeout=STEP):
    """Submit all, wait until every stream finished and every sequence was
    released (its blocks registered)."""
    done = threading.Event()
    left = [len(requests)]
    lock = threading.Lock()

    def emit(o):
        if o.finish_reason is not None:
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()

    for r in requests:
        scheduler.submit(r, emit)
    assert done.wait(timeout)
    deadline = time.monotonic() + timeout
    while scheduler._waiting or any(s is not None for s in scheduler._slots):
        assert time.monotonic() < deadline
        time.sleep(0.001)


def _event_traffic():
    """Wave 1 (admitted whole), then single requests: shared prefixes hit
    the cache, and 24 pages force evictions."""
    rng = np.random.default_rng(17)
    base = rng.integers(1, CFG.vocab_size, 12).tolist()
    wave1 = [base + rng.integers(1, CFG.vocab_size, 5).tolist(),
             rng.integers(1, CFG.vocab_size, 9).tolist(),
             rng.integers(1, CFG.vocab_size, 14).tolist()]
    singles = [base + rng.integers(1, CFG.vocab_size, 7).tolist(),
               rng.integers(1, CFG.vocab_size, 30).tolist(),
               base[:8] + rng.integers(1, CFG.vocab_size, 9).tolist(),
               rng.integers(1, CFG.vocab_size, 26).tolist(),
               base + rng.integers(1, CFG.vocab_size, 3).tolist()]
    return wave1, singles


def _drive(sched, make_request, wave1, singles):
    for i, p in enumerate(wave1):
        sched.submit(make_request(f"w-{i}", p), lambda o: None)
    sched.start()
    try:
        deadline = time.monotonic() + STEP
        while (sched._incoming.qsize() or sched._waiting
               or any(s is not None for s in sched._slots)):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        for i, p in enumerate(singles):
            _serve(sched, [make_request(f"s-{i}", p)])
    finally:
        sched.stop()


def test_scheduler_emits_the_reference_events(params):
    wave1, singles = _event_traffic()
    mine = KvEventBuffer(0x77)
    runner = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    sched = InferenceScheduler(runner, on_stored=mine.on_stored,
                               on_removed=mine.on_removed)
    _drive(sched, lambda rid, p: PreprocessedRequest(
        request_id=rid, token_ids=p,
        sampling=SamplingOptions(max_tokens=6, temperature=0.0, seed=1),
        stop=StopConditions(ignore_eos=True)), wave1, singles)
    theirs = RefEventBuffer(0x77)
    jrunner = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                      params=params)
    jsched = JScheduler(jrunner, on_stored=theirs.on_stored,
                        on_removed=theirs.on_removed)
    _drive(jsched, lambda rid, p: JRequest(
        request_id=rid, token_ids=p,
        sampling=JSampling(max_tokens=6, temperature=0.0, seed=1),
        stop=JStop(ignore_eos=True)), wave1, singles)
    got = [e.to_wire() for e in mine.drain()]
    want = [e.to_wire() for e in theirs.drain()]
    assert got == want
    assert any("r" in e for e in got) and any(
        e.get("s", {}).get("p") is not None for e in got)
    assert [e["e"] for e in got] == list(range(len(got)))
    assert mine.local_index.dump() == theirs.local_index.dump()
    assert sched.stats.prefill_tokens == jsched.stats.prefill_tokens


# -- two port workers behind the port's frontend ----------------------------


class _LoopThread:
    """An event loop on a thread of its own, hosting the servers while the
    test body talks to them over sockets."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = STEP):
        fut = asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, timeout), self.loop)
        return fut.result(timeout + 5)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _request(port: int, body: dict, headers: bool = False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=STEP)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = (resp.status, resp.read().decode())
        return out + (dict(resp.getheaders()),) if headers else out
    finally:
        conn.close()


def _completion(port: int, prompt: list, max_tokens: int = 4) -> dict:
    status, text = _request(port, {"model": MODEL, "prompt": prompt,
                                   "max_tokens": max_tokens,
                                   "temperature": 0.0, "ignore_eos": True})
    assert status == 200, text
    return json.loads(text)


async def _until(pred, what: str, timeout: float = STEP):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.02)


def _port_config(root, **kw) -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="file", discovery_path=str(root),
                         tcp_host="127.0.0.1", system_enabled=False, **kw)


@pytest.fixture(scope="module")
def fleet(params, tmp_path_factory):
    """Two TorchWorkers (one set of weights), each on its own runtime, and
    three port frontends over them: kv, p2c, and round_robin with a busy
    threshold of 0 (every worker always busy)."""
    root = tmp_path_factory.mktemp("fleet")
    lt = _LoopThread()
    state: dict = {"loop": lt}
    shared = params_from_numpy(params, CFG, device="cpu")

    async def up():
        runtimes = [await DistributedRuntime(_port_config(root)).start()
                    for _ in range(3)]
        state["runtimes"] = runtimes
        workers = []
        for rt in runtimes[:2]:
            w = TorchWorker(CFG, RunnerConfig(**SERVE_RUNNER), device="cpu",
                            params=shared)
            w.start()
            await w.serve(rt)
            workers.append(w)
        state["workers"] = workers
        fes = {"kv": Frontend(runtimes[2], host="127.0.0.1", port=0,
                              router_mode="kv"),
               "p2c": Frontend(runtimes[2], host="127.0.0.1", port=0,
                               router_mode="p2c"),
               "busy": Frontend(runtimes[2], host="127.0.0.1", port=0,
                                busy_threshold=0.0)}
        state["frontends"] = fes
        for fe in fes.values():
            await fe.start()
        ids = {w.instance_id for w in workers}
        for fe in fes.values():
            await _until(lambda fe=fe: fe.manager.get(MODEL) is not None
                         and ids <= set(fe.manager.get(MODEL).worker_usage),
                         "load metrics from both workers")

    async def down():
        for fe in state.get("frontends", {}).values():
            await fe.close()
        for w in state.get("workers", []):
            await w.shutdown()
        for rt in state.get("runtimes", []):
            await rt.shutdown()

    try:
        lt.run(up(), timeout=60.0)
        state["ports"] = {k: fe.port for k, fe in state["frontends"].items()}
        yield state
    finally:
        try:
            lt.run(down(), timeout=60.0)
        finally:
            lt.close()


def _router_view(fleet, worker) -> list:
    entry = fleet["frontends"]["kv"].manager.get(MODEL)
    return sorted(entry.scheduler.indexer.dump_worker(
        WorkerWithDpRank(worker.instance_id)), key=str)


def _local_view(worker) -> list:
    return sorted(((p, h) for p, h in worker.events.local_index.dump()[
        "blocks"]), key=str)


def _settled(fleet) -> bool:
    """Every worker idle, its events drained into the router, and its
    latest published load equal to its pool's."""
    entry = fleet["frontends"]["kv"].manager.get(MODEL)
    for w in fleet["workers"]:
        pool = w.scheduler.pool
        pub = entry.scheduler.sequences._published.get(
            WorkerWithDpRank(w.instance_id))
        if (w.scheduler._waiting or any(s is not None for s in
                                        w.scheduler._slots)
                or pub is None
                or pub.active_blocks != pool.num_pages - 1
                - pool.free_count()
                or _router_view(fleet, w) != _local_view(w)):
            return False
    return True


def test_kv_blocks_endpoint_serves_the_local_index(fleet):
    async def go():
        w = fleet["workers"][0]
        client = (fleet["runtimes"][2].namespace(w.card.namespace)
                  .component(w.card.component).endpoint("kv_blocks")
                  .client())
        await client.start()
        try:
            await client.wait_for_instances(2, timeout=STEP)
            return [d async for d in client.direct({}, w.instance_id)], w
        finally:
            await client.close()

    dumps, w = fleet["loop"].run(go())
    assert dumps == [w.events.local_index.dump()]
    assert w.card.runtime_config["kv_blocks_endpoint"] is True


def test_kv_mode_routes_a_shared_prefix_to_its_holder(fleet):
    lt, port = fleet["loop"], fleet["ports"]["kv"]
    workers = fleet["workers"]
    rng = np.random.default_rng(23)
    prefixes = [rng.integers(1, CFG.vocab_size, 16).tolist()
                for _ in range(2)]

    def served_by(before):
        return [i for i, w in enumerate(workers)
                if w.scheduler.stats.steps != before[i]]

    # wave 1: one request per prefix, each sent once the router holds the
    # previous one's events and load, so the second goes to the idle worker
    before = [w.scheduler.stats.prefill_tokens for w in workers]
    for p in prefixes:
        lt.run(_until(lambda: _settled(fleet), "events drained"))
        _completion(port, p + rng.integers(1, CFG.vocab_size, 4).tolist())
    assert all(w.scheduler.stats.prefill_tokens > b
               for w, b in zip(workers, before)), "wave 1 did not split"
    lt.run(_until(lambda: _settled(fleet), "events drained"))
    entry = fleet["frontends"]["kv"].manager.get(MODEL)
    holder = {}
    for i, p in enumerate(prefixes):
        scores = entry.scheduler.indexer.find_matches(
            compute_block_hashes(p, 4)).scores
        (who,) = [w for w, n in scores.items() if n == 4]
        holder[i] = next(k for k, w in enumerate(workers)
                         if w.instance_id == who.worker_id)
    assert sorted(holder.values()) == [0, 1]
    # wave 2: each prefix again, one at a time: to its holder, cache hit
    for i, p in enumerate(prefixes):
        steps = [w.scheduler.stats.steps for w in workers]
        cached = [w.scheduler.stats.prefill_tokens for w in workers]
        suffix = rng.integers(1, CFG.vocab_size, 3).tolist()
        _completion(port, p + suffix)
        assert served_by(steps) == [holder[i]]
        h = workers[holder[i]]
        assert h.scheduler.stats.prefill_tokens - cached[holder[i]] == len(
            suffix)  # the 16-token prefix came from the cache
        lt.run(_until(lambda: _settled(fleet), "events drained"))
    for w in workers:
        assert _router_view(fleet, w) == _local_view(w) != []
    # clear_kv_blocks on worker 0 empties its part of the router's tree
    w0 = workers[0]

    async def clear():
        client = (fleet["runtimes"][2].namespace(w0.card.namespace)
                  .component(w0.card.component).endpoint("clear_kv_blocks")
                  .client())
        await client.start()
        try:
            await client.wait_for_instances(2, timeout=STEP)
            return [d async for d in client.direct({}, w0.instance_id)]
        finally:
            await client.close()

    (answer,) = lt.run(clear())
    assert answer["cleared_blocks"] > 0
    lt.run(_until(lambda: _router_view(fleet, w0) == [], "cleared"))
    assert _local_view(w0) == [] and _router_view(fleet, workers[1]) != []


class _pool:
    """A small thread pool for concurrent HTTP requests."""

    def __init__(self, n: int) -> None:
        import concurrent.futures

        self._ex = concurrent.futures.ThreadPoolExecutor(n)

    def __enter__(self):
        return self._ex

    def __exit__(self, *exc):
        self._ex.shutdown(wait=True)


def test_load_metrics_leave_the_steptrace_split_at_zero(fleet):
    """The worker's LoadMetrics are the reference's fields from its pool and
    scheduler. The device / host split of a step is the last committed
    step's (perf/steptrace.py, as the reference's `_load_metrics` fills it):
    it sums to that step's wall, and it stays at zero until a step
    commits."""
    w = fleet["workers"][1]
    m = w._load_metrics()
    pool = w.scheduler.pool
    assert m.worker_id == w.instance_id and m.total_blocks == pool.num_pages
    assert m.active_blocks == pool.num_pages - 1 - pool.free_count()
    assert m.kv_usage == pool.usage()
    assert (m.active_requests, m.waiting_requests) == (0, 0)
    assert m.step_wall_ms > 0 and m.decode_tokens_in_step >= 0
    last = w.scheduler.steptrace.last
    assert (m.device_ms_in_step, m.host_ms_in_step) == (last.device_ms,
                                                        last.host_ms)
    assert m.device_ms_in_step > 0 and m.host_ms_in_step >= 0
    assert m.device_ms_in_step + m.host_ms_in_step == pytest.approx(
        m.step_wall_ms, rel=1e-9)
    assert m.draining is False
    fresh = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                        params=w.runner.model)
    m = fresh._load_metrics()
    assert (m.device_ms_in_step, m.host_ms_in_step, m.step_wall_ms) == (
        0.0, 0.0, 0.0)
    entry = fleet["frontends"]["kv"].manager.get(MODEL)
    assert set(entry.worker_usage) == {x.instance_id
                                       for x in fleet["workers"]}


def test_p2c_routes(fleet):
    workers = fleet["workers"]
    before = [w.scheduler.stats.steps for w in workers]
    rng = np.random.default_rng(29)
    with _pool(4) as ex:
        outs = list(ex.map(lambda _: _completion(
            fleet["ports"]["p2c"],
            rng.integers(1, CFG.vocab_size, 6).tolist()), range(8)))
    assert all(o["usage"]["completion_tokens"] == 4 for o in outs)
    assert sum(w.scheduler.stats.steps - b
               for w, b in zip(workers, before)) > 0


def test_busy_threshold_answers_503(fleet):
    """The busy 503's Retry-After is the model's estimated drain time, as
    the reference's `_retry_after` computes it: here one request behind an
    idle fleet at the cold drain rate (one request a half-life, 5 s)."""
    entry = fleet["frontends"]["busy"].manager.get(MODEL)
    estimator = QueueWaitEstimator(pool=entry.wait_estimator.pool)
    estimator.observe_drained(1)
    entry.wait_estimator = estimator
    status, text, headers = _request(fleet["ports"]["busy"], {
        "model": MODEL, "prompt": [5, 6, 7], "max_tokens": 2}, headers=True)
    assert status == 503
    assert headers["Retry-After"] == RefHttpService._retry_after(
        None, entry) == "5"
    assert json.loads(text) == {"error": {
        "message": "service busy", "type": "overloaded", "code": 503}}
    fleet["frontends"]["busy"].http.busy_threshold = 1.5
    status, _ = _request(fleet["ports"]["busy"], {
        "model": MODEL, "prompt": [5, 6, 7], "max_tokens": 2})
    assert status == 200


# -- the cross-package kv pairings over the journal --------------------------


def test_kv_routers_score_the_other_package_over_the_journal(params,
                                                            tmp_path):
    """P: the port's kv frontend with the reference's worker; R: the
    reference's kv frontend with the port's worker; both on the journal
    event plane. After one request, each router holds the other package's
    cached prompt blocks and scores them."""
    lt = _LoopThread()
    state: dict = {}
    prompt = np.random.default_rng(31).integers(1, CFG.vocab_size,
                                                18).tolist()
    hashes = compute_block_hashes(prompt, 4)

    def journal(root):
        return dict(discovery_backend="file",
                    discovery_path=str(tmp_path / root / "disc"),
                    event_plane="journal",
                    event_journal_path=str(tmp_path / root / "events"))

    async def up():
        port_p = await DistributedRuntime(RuntimeConfig(
            tcp_host="127.0.0.1", system_enabled=False,
            **journal("P"))).start()
        ref_p = await RefRuntime(RefRuntimeConfig.from_env(
            request_plane="tcp", tcp_host="127.0.0.1", system_enabled=False,
            **journal("P"))).start()
        port_r = await DistributedRuntime(RuntimeConfig(
            tcp_host="127.0.0.1", system_enabled=False,
            **journal("R"))).start()
        ref_r = await RefRuntime(RefRuntimeConfig.from_env(
            request_plane="tcp", tcp_host="127.0.0.1", system_enabled=False,
            **journal("R"))).start()
        state["runtimes"] = [port_p, ref_p, port_r, ref_r]
        ref_worker = TpuWorker(ref_p, model_name=MODEL,
                               runner_config=JRunnerConfig(**SERVE_RUNNER))
        ref_worker.model_config = CFG

        async def shared_params():
            return params, None

        ref_worker._resolve_params = shared_params
        await ref_worker.start()
        state["ref_worker"] = ref_worker
        worker = TorchWorker(CFG, RunnerConfig(**SERVE_RUNNER), device="cpu",
                             params=params_from_numpy(params, CFG,
                                                      device="cpu"))
        worker.start()
        await worker.serve(port_r)
        state["worker"] = worker
        fes = {"P": Frontend(port_p, host="127.0.0.1", port=0,
                             router_mode="kv"),
               "R": RefFrontend(ref_r, host="127.0.0.1", port=0,
                                router_mode="kv")}
        state["frontends"] = fes
        for fe in fes.values():
            await fe.start()
        for fe in fes.values():
            await _until(lambda fe=fe: fe.manager.get(MODEL) is not None
                         and fe.manager.get(MODEL).instances, "listed")

    async def down():
        for fe in state.get("frontends", {}).values():
            await fe.close()
        if "worker" in state:
            await state["worker"].shutdown()
        if "ref_worker" in state:
            await state["ref_worker"].close()
        for rt in state.get("runtimes", []):
            await rt.shutdown()

    def overlap(fe) -> dict:
        entry = fe.manager.get(MODEL)
        return {w.worker_id: n for w, n in
                entry.scheduler.indexer.find_matches(hashes).scores.items()}

    try:
        lt.run(up(), timeout=90.0)
        fes = state["frontends"]
        texts = {}
        for key in ("P", "R"):
            texts[key] = _completion(fes[key].port, prompt)["choices"][0][
                "text"]
            lt.run(_until(lambda key=key: overlap(fes[key]), "scored"))
        got = {key: overlap(fe) for key, fe in fes.items()}
    finally:
        try:
            lt.run(down(), timeout=60.0)
        finally:
            lt.close()
    assert got["P"] == {state["ref_worker"].instance_id: 4}
    assert got["R"] == {state["worker"].instance_id: 4}
    assert texts["P"] == texts["R"]


# -- draining workers --------------------------------------------------------


def test_kv_frontends_drop_a_draining_worker_as_the_reference_does(
        params, tmp_path, caplog):
    """Three reference workers' records on one reference runtime (a served
    `generate` instance, the reference's card, its KV event buffer and load
    metrics on the journal plane), watched by the port's kv frontend and
    the reference's. A announces its departure by its card's `draining`
    flag, B by `LoadMetrics.draining`: each leaves `available()` and its
    radix state goes, and the KV events both send later are ignored, in
    both frontends alike. A's deregistration clears its marks. A card that
    serves neither chat nor completions stays ignored by the port."""
    from dynamo_tpu.kv_router import LOAD_TOPIC
    from dynamo_tpu.kv_router import KV_EVENT_TOPIC
    from dynamo_tpu.kv_router import LoadMetrics as RefLoadMetrics
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
    from dynamo_tpu.llm.model_card import publish_card, unpublish_card

    lt = _LoopThread()
    state: dict = {}
    ids = {"A": 0xA1, "B": 0xB2, "C": 0xC3}
    rng = np.random.default_rng(41)
    # per worker: blocks stored before the drain, blocks sent after it
    prompts = {(w, late): rng.integers(1, CFG.vocab_size, 12).tolist()
               for w in ids for late in (False, True)}
    hashes = {k: compute_block_hashes(p, 4) for k, p in prompts.items()}
    plane = dict(discovery_backend="file", discovery_path=str(tmp_path / "d"),
                 event_plane="journal",
                 event_journal_path=str(tmp_path / "events"))

    async def handler(body, ctx=None):
        return
        yield

    async def up():
        ref_w = await RefRuntime(RefRuntimeConfig.from_env(
            request_plane="tcp", tcp_host="127.0.0.1", system_enabled=False,
            **plane)).start()
        port_fe = await DistributedRuntime(RuntimeConfig(
            tcp_host="127.0.0.1", system_enabled=False, **plane)).start()
        ref_fe = await RefRuntime(RefRuntimeConfig.from_env(
            request_plane="tcp", tcp_host="127.0.0.1", system_enabled=False,
            **plane)).start()
        state["runtimes"] = [ref_w, port_fe, ref_fe]
        endpoint = (ref_w.namespace("dynamo").component("backend")
                    .endpoint("generate"))
        state["served"] = {w: await endpoint.serve_endpoint(
            handler, instance_id=iid) for w, iid in ids.items()}
        state["cards"] = {w: RefCard(name=MODEL, kv_block_size=4)
                          for w in ids}
        for w, iid in ids.items():
            await publish_card(ref_w, state["cards"][w], iid)
        state["publisher"] = ref_w.event_publisher("dynamo")
        state["buffers"] = {w: RefEventBuffer(iid) for w, iid in ids.items()}
        fes = {"port": Frontend(port_fe, host="127.0.0.1", port=0,
                                router_mode="kv"),
               "ref": RefFrontend(ref_fe, host="127.0.0.1", port=0,
                                  router_mode="kv")}
        state["frontends"] = fes
        for fe in fes.values():
            await fe.start()
        for fe in fes.values():
            await _until(lambda fe=fe: available(fe) == sorted(ids.values()),
                         "three instances listed")

    async def store(*keys):
        """Each (worker, late) prompt's blocks stored, published in order."""
        for w, late in keys:
            state["buffers"][w].on_stored(hashes[(w, late)], None)
            for event in state["buffers"][w].drain():
                await state["publisher"].publish(KV_EVENT_TOPIC,
                                                 event.to_wire())

    async def down():
        for fe in state.get("frontends", {}).values():
            await fe.close()
        for rt in state.get("runtimes", []):
            await rt.shutdown()

    def entry(fe):
        return fe.manager.get(MODEL)

    def available(fe) -> list:
        e = entry(fe)
        return sorted(e.router.available()) if e is not None else []

    def overlap(fe, key) -> dict:
        return {w.worker_id: n for w, n in entry(fe).scheduler.indexer
                .find_matches(hashes[key]).scores.items()}

    def both(pred) -> bool:
        return all(pred(fe) for fe in state["frontends"].values())

    try:
        lt.run(up(), timeout=60.0)
        fes = state["frontends"]
        lt.run(store(*((w, False) for w in ids)))
        lt.run(_until(lambda: both(lambda fe: all(
            overlap(fe, (w, False)) == {iid: 3} for w, iid in ids.items())),
            "every worker's blocks indexed"))

        # A: the card flag (the reference worker's announce republishes it)
        state["cards"]["A"].runtime_config["draining"] = True
        lt.run(publish_card(state["runtimes"][0], state["cards"]["A"],
                            ids["A"]))
        lt.run(_until(lambda: both(lambda fe: ids["A"] not in available(fe)),
                      "A leaves selection"))
        # B: the load plane
        lt.run(state["publisher"].publish(LOAD_TOPIC, RefLoadMetrics(
            worker_id=ids["B"], draining=True).to_wire()))
        lt.run(_until(lambda: both(lambda fe: ids["B"] not in available(fe)),
                      "B leaves selection"))
        # later events of A and B, then C's as the marker that they landed
        lt.run(store(("A", True), ("B", True), ("C", True)))
        lt.run(_until(lambda: both(
            lambda fe: overlap(fe, ("C", True)) == {ids["C"]: 3}),
            "C's later blocks indexed"))
        got = {name: (available(fe),
                      {key: overlap(fe, key) for key in hashes},
                      set(entry(fe).draining))
               for name, fe in fes.items()}

        # A deregisters: its marks go with its records
        lt.run(unpublish_card(state["runtimes"][0], state["cards"]["A"],
                              ids["A"]))
        lt.run(state["served"]["A"].shutdown(drain_timeout=1.0))
        lt.run(_until(lambda: both(
            lambda fe: ids["A"] not in entry(fe).instances
            and ids["A"] not in entry(fe).router._draining),
            "A deregistered"))
        after = {name: set(entry(fe).draining) for name, fe in fes.items()}

        # a card the port does not serve yet
        with caplog.at_level("WARNING", logger="dynamo_tpu_torch.manager"):
            lt.run(publish_card(state["runtimes"][0], RefCard(
                name="tiny-embed", model_types=["embedding"],
                kv_block_size=4), 0xD4))
            lt.run(_until(lambda: any("tiny-embed" in r.getMessage()
                                      for r in caplog.records),
                          "the port's watcher saw the embedding card"))
        port_models = [c.name for c in fes["port"].manager.list_models()]
    finally:
        try:
            lt.run(down(), timeout=60.0)
        finally:
            lt.close()
    assert got["port"] == got["ref"]
    avail, overlaps, draining = got["port"]
    assert avail == [ids["C"]]
    assert draining == {ids["A"], ids["B"]}
    assert overlaps == {(w, late): ({ids["C"]: 3} if w == "C" else {})
                        for w, late in hashes}
    assert after == {"port": {ids["B"]}, "ref": {ids["B"]}}
    assert port_models == [MODEL]
