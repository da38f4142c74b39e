"""Disaggregated prefill/decode serving in the port, held against the JAX
engine (tiny-test, float32, CPU, all in this process; 127.0.0.1 only).

Three discovery trees, each with a prefill worker (`[PREFILL]` card, the
`prefill` component) and a decode worker, and one frontend of each package:

  port  - a port prefill worker and a port decode worker
  ref   - a JAX prefill worker and a port decode worker
  mixed - a port prefill worker and a JAX decode worker

Every request goes through a frontend's pipeline (Migration ->
PrefillRouterEngine -> router -> worker): the prefill leg parks the
prompt's pages and answers `kv_transfer_params`, streamed after the first
of four 8-token chunks (DYNT_DISAGG_PIPELINE=1) or after the whole prompt
(0), and the decode worker pulls them over `kv_pull` (frames across the
packages) and decodes without a prefill pass. Greedy streams must equal the
JAX engine's aggregated stream exactly (tolerance 0: token ids); the decode
worker computes 0 prompt tokens; every transfer is claimed and the prefill
worker's pool returns to its free count. Then the transfer table's
lifecycle in a port worker: a TTL expiry, a puller that dies mid-stream and
a cancelled prefill each release the pages exactly once; the prefill pool
goes when its last card goes and the frontend serves aggregated again.
"""

import asyncio
import dataclasses
import threading
import time

import jax
import pytest

from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.frontend import Frontend as RefFrontend
from dynamo_tpu.llm import protocols as ref_protocols
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.engine.worker import build_arg_parser, main
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.llm import protocols as port_protocols
from dynamo_tpu_torch.llm.kv_transfer import KvLayoutDescriptor
from dynamo_tpu_torch.llm.model_card import PREFILL
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
# a max chunk of 8: a 30-token prompt prefills in 4 chunks
RUNNER = dict(page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(8,))
MODEL = "tiny-test"
PROMPT = list(range(30, 60))  # 30 tokens: 8 pages, the last one partial
MAX_TOKENS = 6
STEP = 60.0
TREES = ("port", "ref", "mixed")


class _LoopThread:
    """An event loop on its own thread, hosting every server."""

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


def _port_config(root) -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="file", discovery_path=str(root),
                         tcp_host="127.0.0.1", lease_ttl_secs=10.0,
                         system_enabled=False)


def _ref_config(root) -> RefRuntimeConfig:
    return RefRuntimeConfig.from_env(
        discovery_backend="file", discovery_path=str(root),
        request_plane="tcp", tcp_host="127.0.0.1", event_plane="mem",
        system_enabled=False)


def _usable(pool) -> int:
    """Pages free or evictable (a released prompt's full pages may stay in
    the prefix cache)."""
    return pool.free_count() + pool.cached_count()


async def _until(pred, what: str, timeout: float = 20.0) -> None:
    t = time.monotonic()
    while not pred():
        assert time.monotonic() - t < timeout, what
        await asyncio.sleep(0.01)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    params = jax.device_get(j_init(jax.random.PRNGKey(0), CFG))
    root = tmp_path_factory.mktemp("disagg")
    lt = _LoopThread()
    state: dict = {"runtimes": [], "port_workers": [], "ref_workers": [],
                   "frontends": {}}
    shared = params_from_numpy(params, CFG, device="cpu")

    def port_worker(mode: str, component: str) -> TorchWorker:
        w = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                        params=shared, mode=mode, component=component)
        w.start()
        state["port_workers"].append(w)
        return w

    async def ref_worker(rt, mode: str, component: str) -> TpuWorker:
        w = TpuWorker(rt, model_name=MODEL, component=component, mode=mode,
                      runner_config=JRunnerConfig(**RUNNER), warmup=False)
        w.model_config = CFG

        async def shared_params():
            return params, None

        w._resolve_params = shared_params
        state["ref_workers"].append(w)
        await w.start()
        return w

    async def up():
        trees = {}
        for name in TREES:
            port_rt = await DistributedRuntime(
                _port_config(root / name)).start()
            ref_rt = await RefRuntime(_ref_config(root / name)).start()
            state["runtimes"] += [port_rt, ref_rt]
            if name == "ref":
                prefill = await ref_worker(ref_rt, "prefill", "prefill")
            else:
                prefill = port_worker("prefill", "prefill")
                await prefill.serve(port_rt)
            if name == "mixed":
                decode = await ref_worker(ref_rt, "decode", "backend")
            else:
                decode = port_worker("decode", "backend")
                await decode.serve(port_rt)
            trees[name] = {"prefill": prefill, "decode": decode}
            for side, fe in (("port", Frontend(port_rt, host="127.0.0.1",
                                               port=0)),
                             ("ref", RefFrontend(ref_rt, host="127.0.0.1",
                                                 port=0))):
                await fe.start()
                state["frontends"][(name, side)] = fe
        for fe in state["frontends"].values():
            await _until(lambda fe=fe: fe.manager.get(MODEL) is not None
                         and (fe.watcher._prefill_pools.get(MODEL)
                              is not None), "model and prefill pool listed")
        state["trees"] = trees
        # the JAX engine's aggregated streams: the mixed tree's JAX decode
        # worker, called directly (no prefill leg)
        jax_worker = trees["mixed"]["decode"]
        state["want"] = {}
        for temperature in (0.0, 0.8):
            body = _request(ref_protocols, "want", temperature).to_wire()
            frames = [f async for f in jax_worker.generate(body)]
            state["want"][temperature] = [t for f in frames
                                          for t in f.get("t", [])]

    async def down():
        for fe in state["frontends"].values():
            await fe.close()
        for w in state["port_workers"]:
            await w.shutdown()
        for w in state["ref_workers"]:
            await w.close()
        for rt in state["runtimes"]:
            await rt.shutdown()

    try:
        lt.run(up(), timeout=240.0)
        state["loop"] = lt
        yield state
    finally:
        try:
            lt.run(down(), timeout=60.0)
        finally:
            lt.close()


def _request(protocols, rid: str, temperature: float = 0.0,
             prompt=PROMPT, max_tokens: int = MAX_TOKENS):
    return protocols.PreprocessedRequest(
        request_id=rid, token_ids=list(prompt),
        sampling=protocols.SamplingOptions(max_tokens=max_tokens,
                                           temperature=temperature, seed=7),
        stop=protocols.StopConditions(ignore_eos=True))


async def _through(fe, protocols, rid: str, temperature: float) -> list:
    """One request through a frontend's serving pipeline: token ids."""
    engine = fe.manager.get(MODEL).engine
    tokens = []
    async for out in engine.generate(_request(protocols, rid, temperature)):
        assert out.error is None, out.error
        tokens += out.token_ids
    return tokens


def _stats(worker):
    return worker.scheduler.stats


def _clear_cache(lt, *workers) -> None:
    """Empty the workers' prefix caches, on their scheduler threads: every
    case then prefills (and streams) its whole prompt."""
    for w in workers:
        q = w.scheduler.run_in_step(w.scheduler.pool.clear)
        _, exc = q.get(timeout=STEP)
        assert exc is None


@pytest.mark.parametrize("pipeline", [1, 0], ids=["streamed", "serial"])
@pytest.mark.parametrize("frontend", ["port", "ref"])
@pytest.mark.parametrize("tree", TREES)
def test_disagg_streams_equal_the_jax_engine(stacks, tree, frontend,
                                             pipeline):
    lt = stacks["loop"]
    prefill = stacks["trees"][tree]["prefill"]
    decode = stacks["trees"][tree]["decode"]
    fe = stacks["frontends"][(tree, frontend)]
    protocols = port_protocols if frontend == "port" else ref_protocols
    prefill.disagg_pipeline = pipeline
    _clear_cache(lt, prefill, decode)
    streamed0 = _stats(prefill).disagg_streamed_pages
    prefill_tokens0 = _stats(decode).prefill_tokens
    usable0 = _usable(prefill.scheduler.pool)
    temps = (0.0, 0.8) if tree == "port" else (0.0,)
    for temperature in temps:
        got = lt.run(_through(fe, protocols,
                              f"{tree}-{frontend}-{pipeline}-{temperature}",
                              temperature))
        assert got == stacks["want"][temperature], (temperature, got)
    # the decode worker prefilled nothing: the pages were pulled
    assert _stats(decode).prefill_tokens == prefill_tokens0
    streamed = _stats(prefill).disagg_streamed_pages - streamed0
    assert (streamed > 0) if pipeline else (streamed == 0)
    # every transfer claimed; the prefill pool whole again

    async def released():
        await _until(lambda: len(prefill.transfers) == 0
                     and _usable(prefill.scheduler.pool) >= usable0,
                     "transfers claimed and pages back")

    lt.run(released())
    assert _usable(prefill.scheduler.pool) == RUNNER["num_pages"] - 1


def test_pulled_pages_equal_the_prefill_workers(stacks):
    """The bundle the decode worker pulled equals the prefill worker's
    pages byte for byte (gathered on both sides before the release)."""
    lt = stacks["loop"]
    prefill = stacks["trees"]["port"]["prefill"]
    decode = stacks["trees"]["port"]["decode"]
    prefill.disagg_pipeline = 0
    seen = {}
    release = prefill.scheduler.release_transfer_pages

    def gather_then_release(seq):
        n = -(-seq.prompt_len // RUNNER["page_size"])
        seen["src"] = prefill.runner.gather_pages(
            [int(p) for p in seq.block_table[:n]])
        release(seq)

    stage = decode.runner.stage_bundle

    def keep(blocks):
        seen["pulled"] = blocks.clone()
        return stage(blocks)

    prefill.scheduler.release_transfer_pages = gather_then_release
    decode.runner.stage_bundle = keep
    try:
        got = lt.run(_through(stacks["frontends"][("port", "port")],
                              port_protocols, "bytes", 0.0))
    finally:
        del prefill.scheduler.release_transfer_pages
        del decode.runner.stage_bundle
    assert got == stacks["want"][0.0]
    assert seen["pulled"].shape == seen["src"].shape
    assert seen["pulled"].numpy().tobytes() == seen["src"].numpy().tobytes()
    pull = decode.pulls[-1]
    assert pull["bytes"] == seen["src"].numel() * 4 and pull["pages"] == 8


def test_prefill_only_request_is_served(stacks):
    """A prefill-only request to an aggregated worker parks its pages and
    answers kv_transfer_params with the first token, as the reference."""
    lt = stacks["loop"]
    worker = stacks["trees"]["port"]["decode"]
    body = _request(port_protocols, "po", max_tokens=1).to_wire()
    body["annotations"] = {"prefill_only": True}
    usable0 = _usable(worker.scheduler.pool)

    async def serve():
        return [f async for f in worker.generate(body)]

    saved = worker.disagg_pipeline
    worker.disagg_pipeline = 0
    try:
        frames = lt.run(serve())
    finally:
        worker.disagg_pipeline = saved
    last = port_protocols.EngineOutput.from_wire(frames[-1])
    assert last.finish_reason == "stop" and last.prompt_tokens == len(PROMPT)
    params = last.kv_transfer_params
    assert params["first_token"] == stacks["want"][0.0][0]
    assert params["layout"] == KvLayoutDescriptor.from_wire(
        worker.runner.kv_layout()).to_wire()
    assert params["instance_id"] == worker.instance_id
    transfer = worker.transfers.claim(params["transfer_id"])
    assert transfer is not None and len(transfer.page_ids) == 8
    transfer.release()

    async def back():
        await _until(lambda: _usable(worker.scheduler.pool) >= usable0,
                     "the claimed pages came back")

    lt.run(back())


def test_ttl_expiry_releases_the_pages_once(stacks):
    lt = stacks["loop"]
    worker = stacks["trees"]["port"]["prefill"]
    worker.disagg_pipeline = 0
    usable0 = _usable(worker.scheduler.pool)
    body = _request(port_protocols, "ttl", max_tokens=1).to_wire()

    async def serve():
        return [f async for f in worker.generate(body)]

    frames = lt.run(serve())
    assert frames[-1]["kv"]["transfer_id"]
    assert len(worker.transfers) == 1
    assert _usable(worker.scheduler.pool) < usable0
    worker.transfers.ttl_secs = 0.0
    try:
        assert worker.transfers.expire_stale() == 1
        assert worker.transfers.expire_stale() == 0
    finally:
        worker.transfers.ttl_secs = 120.0

    async def back():
        await _until(lambda: _usable(worker.scheduler.pool) == usable0,
                     "the expired pages came back")

    lt.run(back())
    assert _usable(worker.scheduler.pool) == RUNNER["num_pages"] - 1


def _prefill_only(worker, emit, rid: str):
    req = _request(port_protocols, rid, prompt=list(range(30, 62)),
                   max_tokens=1)
    return worker.scheduler.submit(
        req, emit, prefill_only=True,
        on_prefill_done=worker._register_transfer,
        on_prefill_chunk=worker._stream_transfer_chunk)


def test_puller_dying_mid_stream_releases_once(stacks):
    """A puller that claims a streaming transfer and dies while the prompt
    pass still runs: the pages do not return while chunks still write
    them; the sequence is cancelled (a terminal frame ends the prefill
    leg) and the reap releases them, exactly once."""
    lt = stacks["loop"]
    worker = stacks["trees"]["port"]["prefill"]
    sched = worker.scheduler
    _clear_cache(lt, worker)  # the whole prompt prefills, in 4 chunks
    before = _usable(sched.pool)
    outputs = []

    def emit(out):
        outputs.append(out)
        if out.kv_transfer_params is not None and out.finish_reason is None:
            t = worker.transfers.claim(out.kv_transfer_params["transfer_id"])
            assert t is not None
            t.release()  # mid-prefill: must not free pages yet

    _prefill_only(worker, emit, "dies")

    async def settled():
        await _until(lambda: any(o.finish_reason is not None
                                 for o in outputs), "a terminal frame")
        await _until(lambda: _usable(sched.pool) >= before
                     and len(worker.transfers) == 0
                     and not worker._stream_transfers
                     and all(s is None for s in sched._slots),
                     "released")

    lt.run(settled())
    assert _usable(sched.pool) == before
    assert any(o.finish_reason == "cancelled" for o in outputs)


def test_cancel_mid_stream_fails_the_transfer(stacks):
    lt = stacks["loop"]
    worker = stacks["trees"]["port"]["prefill"]
    sched = worker.scheduler
    _clear_cache(lt, worker)
    before = _usable(sched.pool)
    streamed0 = sched.stats.disagg_streamed_pages
    outputs, box = [], {}

    def emit(out):
        outputs.append(out)
        if out.kv_transfer_params is not None and out.finish_reason is None:
            box["h"].cancel()  # on the scheduler thread, between chunks

    box["h"] = _prefill_only(worker, emit, "cancelled")

    async def settled():
        await _until(lambda: sched.stats.disagg_streamed_pages > streamed0
                     and _usable(sched.pool) >= before
                     and len(worker.transfers) == 0
                     and not worker._stream_transfers
                     and all(s is None for s in sched._slots), "released")

    lt.run(settled())
    assert _usable(sched.pool) == before
    assert not any(o.finish_reason == "stop" for o in outputs)


def test_first_token_honours_logits_processors(stacks):
    """The prefill worker samples the first token without processors; the
    decode side discards it and regenerates it through the host path, so a
    forced response controls the whole stream."""
    lt = stacks["loop"]
    fe = stacks["frontends"][("port", "port")]
    stacks["trees"]["port"]["prefill"].disagg_pipeline = 1
    req = _request(port_protocols, "forced", max_tokens=3)
    req.logits_processors = [{"name": "forced_response",
                              "args": {"token_ids": [21, 22, 23],
                                       "eos_id": 1}}]

    async def serve():
        tokens = []
        async for out in fe.manager.get(MODEL).engine.generate(req):
            assert out.error is None, out.error
            tokens += out.token_ids
        return tokens

    assert lt.run(serve()) == [21, 22, 23]


def test_the_pool_falls_back_when_its_last_card_goes(stacks):
    """The port tree's prefill worker deregisters: both frontends drop the
    pool and serve aggregated on the decode worker (which now prefills),
    with the same stream. Runs last: the prefill worker is gone after."""
    lt = stacks["loop"]
    prefill = stacks["trees"]["port"]["prefill"]
    decode = stacks["trees"]["port"]["decode"]
    fes = [stacks["frontends"][("port", side)] for side in ("port", "ref")]

    _clear_cache(lt, decode)

    async def go():
        await prefill.shutdown()
        await _until(lambda: all(fe.watcher._prefill_pools.get(MODEL)
                                 is None for fe in fes),
                     "the prefill pools went")
        out = []
        for fe, protocols in zip(fes, (port_protocols, ref_protocols)):
            before = _stats(decode).prefill_tokens
            out.append(await _through(fe, protocols, f"agg-{len(out)}", 0.0))
            # the first request prefills the prompt; the second finds its
            # 7 full pages in the cache
            assert _stats(decode).prefill_tokens - before == (
                len(PROMPT) if not out[1:] else len(PROMPT) - 28)
        return out

    assert lt.run(go()) == [stacks["want"][0.0]] * 2
    stacks["port_workers"].remove(prefill)


def test_card_and_cli_modes():
    worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                         mode="prefill")
    assert worker.card.model_types == [PREFILL]
    with pytest.raises(ValueError, match="mode"):
        TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu", mode="comesh")
    args = build_arg_parser().parse_args(["--mode", "prefill"])
    assert (args.mode, args.component) == ("prefill", "backend")
    # comesh is one process holding both pools (engine/ici_transfer.py),
    # one device each by default; its checks are the reference's
    args = build_arg_parser().parse_args(["--mode", "comesh"])
    assert (args.mode, args.prefill_devices, args.decode_devices,
            args.dp) == ("comesh", 1, 1, 1)
    with pytest.raises(SystemExit, match="--dp is not meaningful"):
        asyncio.run(main(["--mode", "comesh", "--dp", "2",
                          "--device", "cpu"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNT_SNAPSHOT_MODE", "dump")
        with pytest.raises(SystemExit, match="snapshot-gated"):
            asyncio.run(main(["--mode", "comesh", "--device", "cpu"]))
    # a pool of two devices would be tensor parallel: not ported
    with pytest.raises(SystemExit, match="tensor parallelism"):
        asyncio.run(main(["--mode", "comesh", "--prefill-devices", "2",
                          "--device", "cpu"]))
    # an int8 pool serves aggregated only, as the reference's CLI says
    for mode in ("decode", "comesh"):
        with pytest.raises(SystemExit, match="kv-dtype"):
            asyncio.run(main(["--mode", mode, "--kv-dtype", "int8",
                              "--device", "cpu"]))
