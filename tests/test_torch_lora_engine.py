"""Multi-LoRA in the port's engine and serving edge against the JAX
package, on the CPU: the runner's slot pack (writes in place, the base
restored by a cleared slot, prewarm's keys), the scheduler's slots (the
prefix cache salted by adapter, `lora_in_flight` with a parked sequence),
the worker's `lora_load` / `lora_unload` / `lora_list` endpoints and
in-band refusal beside a JAX worker, and the frontend's adapter routing
(`ModelManager.resolve` / `list_adapters` on both packages' cards, both
router engines' instance filter). Helpers and adapter files come from
tests/test_torch_lora.py.

Tolerances: a written slot's logits 1e-4 against the JAX forward (float32);
slot 0 and a cleared slot against the base, and every stream (greedy and
host-sampled, port against the JAX worker) exactly. Binds nothing beyond
the mem request plane and spawns no process.
"""

import asyncio
import contextlib
import dataclasses
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import forward as j_forward
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import make_kv_cache as j_make_kv
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu.runtime.push_router import PushRouter as RefPushRouter
from dynamo_tpu_torch.engine import (
    InferenceScheduler,
    ModelRunner,
    RunnerConfig,
    TorchWorker,
)
from dynamo_tpu_torch.kv_router import KvScheduler
from dynamo_tpu_torch.llm import lora
from dynamo_tpu_torch.llm.engine import KvRouterEngine, RouterEngine
from dynamo_tpu_torch.llm.manager import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.models import transformer as tt
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.push_router import (
    NoInstancesAvailable,
    PushRouter,
)
from test_torch_lora import RANK, _TINY, _adapter_file, _jax_pack, _managers

# -- the runner's slot pack ------------------------------------------------------

RUNNER = dict(page_size=4, num_pages=64, max_batch=4, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
CFG = dataclasses.replace(_TINY, dtype="float32")


@pytest.fixture(scope="module")
def params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _runner(params, max_loras=2, **kw) -> ModelRunner:
    return ModelRunner(CFG, RunnerConfig(max_loras=max_loras, lora_rank=RANK,
                                         **{**RUNNER, **kw}),
                       device="cpu",
                       params=params_from_numpy(params, CFG, device="cpu"))


def _prefill_logits(runner, prompt, slot) -> np.ndarray:
    table = np.arange(1, RUNNER["max_pages_per_seq"] + 1, dtype=np.int32)
    runner.prefill_chunk(np.asarray(prompt, np.int32), 0, table, len(prompt),
                         (0.0, 1.0, 0, 0), want_logits=True, lora_idx=slot)
    return runner.last_prefill_logits


def test_slot_writes_in_place_and_a_cleared_slot_restores_the_base(
        params, tmp_path):
    """set_lora_slot / clear_lora_slot write into the captured storage
    (every pack tensor keeps its data_ptr); slot 0 and a cleared slot give
    the base model's logits bit for bit; a written slot gives the JAX
    forward's with the same adapter in the same slot (1e-4, float32)."""
    runner = _runner(params)
    plain = _runner(params, max_loras=0)
    assert plain.lora_pack is None and plain.lora_pack_bytes() == 0
    ptrs = [t.data_ptr() for layer in runner.lora_pack
            for entry in layer.values() for t in entry.values()]
    path = _adapter_file(tmp_path, "A", CFG, tt.LORA_TARGETS, RANK, 1)
    port_mgr, ref_mgr = _managers(CFG, [path])
    adapter = port_mgr._by_name["a0"]
    prompt = np.random.default_rng(2).integers(1, CFG.vocab_size, 13)
    base = _prefill_logits(plain, prompt, 0)
    assert np.array_equal(_prefill_logits(runner, prompt, 0), base)
    runner.set_lora_slot(adapter.slot, adapter)
    tuned = _prefill_logits(runner, prompt, adapter.slot)
    assert np.array_equal(_prefill_logits(runner, prompt, 0), base)
    table = np.arange(1, RUNNER["max_pages_per_seq"] + 1, dtype=np.int32)
    j_logits = jax.jit(j_forward, static_argnums=1)(
        params, CFG, jnp.asarray(prompt[None], jnp.int32),
        jnp.arange(len(prompt))[None],
        j_make_kv(CFG, RUNNER["num_pages"], RUNNER["page_size"]),
        jnp.asarray(table[None]), jnp.asarray([len(prompt)]),
        lora=_jax_pack(CFG, [ref_mgr._by_name["a0"]]),
        lora_idx=jnp.asarray([adapter.slot]))[1][0, -1]
    np.testing.assert_allclose(tuned, np.asarray(j_logits), rtol=0,
                               atol=1e-4)
    assert float(np.abs(tuned - base).max()) > 1e-2
    runner.clear_lora_slot(adapter.slot)
    assert np.array_equal(_prefill_logits(runner, prompt, adapter.slot),
                          base)
    assert ptrs == [t.data_ptr() for layer in runner.lora_pack
                    for entry in layer.values() for t in entry.values()]
    with pytest.raises(ValueError, match="bad lora slot 3"):
        runner.set_lora_slot(3, adapter)
    with pytest.raises(RuntimeError, match="max_loras=0"):
        plain.clear_lora_slot(1)
    dims = tt.lora_target_dims(CFG)
    assert runner.lora_pack_bytes() == 4 * CFG.n_layers * 3 * RANK * sum(
        din + dout for din, dout in dims.values())


def test_prewarm_captures_the_same_keys_with_the_pack(params, monkeypatch):
    """`lora_idx` is a static input, not a key: prewarm captures the key
    space of a runner without a pack, and a mixed-adapter decode replays a
    prewarmed key."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "4")
    keys = {}
    for n in (0, 2):
        runner = _runner(params, max_loras=n)
        runner.prewarm()
        keys[n] = set(runner.step_graphs)
        if n:
            captures = runner.graph_captures
            b = RUNNER["max_batch"]
            zeros = np.zeros(b, np.int32)
            runner.decode(zeros, zeros, np.zeros((b, 8), np.int32), zeros,
                          np.ones(b, bool), np.ones(b, np.float32),
                          np.ones(b, np.float32), zeros,
                          np.zeros(b, np.uint32),
                          lora_idx=np.asarray([0, 1, 2, 1], np.int32))
            assert runner.graph_captures == captures
            assert all("lora_idx" in g.inputs
                       for g in runner.step_graphs.values())
    assert keys[0] == keys[2] and keys[0]


def _request(rid, prompt, max_tokens=8, lora_name=None, **sampling):
    sampling.setdefault("temperature", 0.0)
    return PreprocessedRequest(
        request_id=rid, token_ids=list(prompt),
        sampling=SamplingOptions(max_tokens=max_tokens, seed=7, **sampling),
        stop=StopConditions(ignore_eos=True), lora_name=lora_name)


class _Stream:
    def __init__(self):
        self.outputs = []

    def emit(self, out):
        self.outputs.append(out)

    @property
    def tokens(self):
        return [t for o in self.outputs for t in o.token_ids]

    @property
    def done(self):
        return bool(self.outputs) and \
            self.outputs[-1].finish_reason is not None


def _pump(sched, done, limit=2000):
    for _ in range(limit):
        if done():
            return
        sched._drain_control()
        sched._drain_incoming()
        if not sched._step():
            sched._drain_gap()
    raise AssertionError("the scheduler stalled")


def test_base_and_adapter_requests_share_no_prefix_pages(params, tmp_path):
    """The same prompt on the base model and on an adapter: block hashes
    salted by the adapter name, so the second request prefills everything;
    two base requests share the cached pages."""
    runner = _runner(params)
    path = _adapter_file(tmp_path, "A", CFG, tt.LORA_TARGETS, RANK, 1)
    mgr = lora.LoraManager(CFG, 2, RANK)
    runner.set_lora_slot(1, mgr.load("A", path))
    prompt = np.random.default_rng(4).integers(1, CFG.vocab_size, 17)
    prefilled = []
    for second in (("A", 1), (None, 0)):
        sched = InferenceScheduler(runner)
        streams = [_Stream(), _Stream()]
        sched.submit(_request("base", prompt), streams[0].emit)
        _pump(sched, lambda: streams[0].done)
        before = sched.stats.prefill_tokens
        sched.submit(_request("again", prompt, lora_name=second[0]),
                     streams[1].emit, lora_idx=second[1])
        _pump(sched, lambda: streams[1].done)
        prefilled.append(sched.stats.prefill_tokens - before)
        if second[0]:
            assert streams[1].tokens != streams[0].tokens
    assert prefilled[0] == len(prompt)  # nothing shared across the salt
    assert prefilled[1] < len(prompt)


def test_lora_in_flight_counts_a_parked_sequence(params, tmp_path,
                                                  monkeypatch):
    """ROADMAP Queue 3: a batch request on an adapter is parked by an
    interactive arrival. The port's `lora_in_flight` counts it (an unload
    would free the slot it resumes on); the reference's does not. The
    resumed stream equals the reference's, token for token."""
    monkeypatch.setenv("DYNT_PREEMPT_ENABLE", "1")
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "1")  # a step a token
    from test_torch_preemption import ParkStore

    path = _adapter_file(tmp_path, "A", CFG, tt.LORA_TARGETS, RANK, 1)
    port_mgr, ref_mgr = _managers(CFG, [path])
    runners = {
        "port": _runner(params, max_batch=1),
        "ref": JRunner(CFG, JRunnerConfig(max_loras=2, lora_rank=RANK,
                                          max_batch=1, **{
                                              k: v for k, v in RUNNER.items()
                                              if k != "max_batch"}),
                       make_mesh(MeshConfig()), params=params)}
    runners["port"].set_lora_slot(1, port_mgr._by_name["a0"])
    runners["ref"].set_lora_slot(1, ref_mgr._by_name["a0"])
    prompt = np.random.default_rng(5).integers(1, CFG.vocab_size, 10).tolist()
    inter = np.random.default_rng(6).integers(1, CFG.vocab_size, 9).tolist()
    out = {}
    for pkg, runner in runners.items():
        cls, req, samp, stop = (
            (InferenceScheduler, PreprocessedRequest, SamplingOptions,
             StopConditions) if pkg == "port"
            else (JScheduler, JRequest, JSampling, JStop))
        sched = cls(runner, kvbm=ParkStore())
        batch, fast = _Stream(), _Stream()
        sched.submit(req(request_id="b", token_ids=prompt,
                         sampling=samp(max_tokens=24, temperature=0.0),
                         stop=stop(ignore_eos=True), priority="batch",
                         lora_name="a0"), batch.emit, lora_idx=1)
        _pump(sched, lambda: len(batch.tokens) >= 4)
        sched.submit(req(request_id="i", token_ids=inter,
                         sampling=samp(max_tokens=4, temperature=0.0),
                         stop=stop(ignore_eos=True),
                         priority="interactive"), fast.emit)
        _pump(sched, lambda: sched.stats.preempt_parked == 1)
        parked = sched.lora_in_flight(1)
        _pump(sched, lambda: batch.done and fast.done)
        out[pkg] = (parked, batch.tokens, sched.stats.preempt_resumed,
                    sched.lora_in_flight(1))
    assert out["port"][0] == 1 and out["ref"][0] == 0
    assert out["port"][1:] == out["ref"][1:]
    assert out["port"][2] == 1 and out["port"][3] == 0


# -- the worker over the request plane, against the JAX worker -----------------


def _port_rt() -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="mem",
                         discovery_path=uuid.uuid4().hex,
                         request_plane="mem", event_plane="mem",
                         system_enabled=False, lease_ttl_secs=10.0)


def _ref_rt() -> RefRuntimeConfig:
    return RefRuntimeConfig.from_env(
        discovery_backend="mem", discovery_path=uuid.uuid4().hex,
        request_plane="mem", event_plane="mem", system_enabled=False)


def _wire(pkg, rid, prompt, max_tokens, lora_name, **sampling):
    req, samp, stop = ((PreprocessedRequest, SamplingOptions, StopConditions)
                       if pkg == "port" else (JRequest, JSampling, JStop))
    sampling.setdefault("temperature", 0.0)
    return req(request_id=rid, token_ids=list(prompt),
               sampling=samp(max_tokens=max_tokens, seed=3, **sampling),
               stop=stop(ignore_eos=True), lora_name=lora_name).to_wire()


async def _generate(worker, body) -> tuple:
    tokens, err = [], None
    async for frame in worker.generate(body):
        tokens += frame.get("t") or []
        err = frame.get("err") or err
    return tokens, err


async def _call(router, body) -> dict:
    return [item async for item in router.generate(body)][-1]


def test_worker_serves_adapters_like_the_jax_worker(params, run, tmp_path):
    """Both workers load one adapter file through their `lora_load`
    endpoints; greedy and host-sampled (repetition penalty) adapter streams
    are equal across the packages and differ from the base streams; an
    unload is refused while an adapter stream is live, succeeds after it,
    and an unloaded adapter is refused in band; the cards advertise the
    loaded names."""
    path = _adapter_file(tmp_path, "A", CFG, tt.LORA_TARGETS, RANK, 1,
                         scale=2.0)
    prompt = np.random.default_rng(8).integers(1, CFG.vocab_size, 14).tolist()
    rc = dict(max_loras=2, lora_rank=RANK, **RUNNER)

    async def go():
        rt = await DistributedRuntime(_port_rt()).start()
        ref_rt = await RefRuntime(_ref_rt()).start()
        worker = TorchWorker(CFG, RunnerConfig(**rc), device="cpu",
                             params=params_from_numpy(params, CFG,
                                                      device="cpu"))
        ref = TpuWorker(ref_rt, model_name="tiny-test",
                        runner_config=JRunnerConfig(**rc), warmup=False)
        ref.model_config = CFG

        async def shared():
            return params, None

        ref._resolve_params = shared
        routers = []
        out = {}
        try:
            worker.start()
            await worker.serve(rt)
            await ref.start()
            for r, mk in ((rt, PushRouter), (ref_rt, RefPushRouter)):
                pair = {}
                for ep in ("lora_load", "lora_unload", "lora_list"):
                    router = mk(r.namespace("dynamo").component("backend")
                                .endpoint(ep).client(), mode="round_robin")
                    await router.client.start()
                    routers.append(router)
                    pair[ep] = router
                out.setdefault("routers", []).append(pair)
            port_eps, ref_eps = out["routers"]
            out["loaded"] = [await _call(eps["lora_load"],
                                         {"name": "A", "path": path})
                             for eps in (port_eps, ref_eps)]
            out["cards"] = [dict(worker.card.runtime_config),
                            dict(ref.card.runtime_config)]
            out["list"] = [await _call(eps["lora_list"], {})
                           for eps in (port_eps, ref_eps)]
            for pkg, w in (("port", worker), ("ref", ref)):
                for kind, extra in (("greedy", {}),
                                    ("penalty", {"repetition_penalty": 1.3}),
                                    ("base", {})):
                    name = None if kind == "base" else "A"
                    out[(pkg, kind)] = await _generate(
                        w, _wire(pkg, f"{pkg}-{kind}", prompt, 10, name,
                                 **extra))
            # a live adapter stream holds the slot
            stream = worker.generate(_wire("port", "long", prompt, 40, "A"))
            first = await stream.__anext__()
            out["busy"] = await _call(port_eps["lora_unload"], {"name": "A"})
            rest = [f async for f in stream]
            out["long"] = (first, rest[-1])
            out["unloaded"] = await _call(port_eps["lora_unload"],
                                          {"name": "A"})
            out["after"] = await _generate(
                worker, _wire("port", "after", prompt, 4, "A"))
            out["card_after"] = list(worker.card.runtime_config["loras"])
            out["missing"] = await _call(port_eps["lora_unload"],
                                         {"name": "A"})
        finally:
            for router in routers:
                await router.client.close()
            await worker.shutdown()
            await ref.close()
            await rt.shutdown()
            await ref_rt.shutdown()
        return out

    out = run(go(), timeout=120)
    assert out["loaded"][0] == out["loaded"][1] == {
        "ok": True, "name": "A", "slot": 1}
    for cfg in out["cards"]:
        assert cfg["lora"] == {"max_loras": 2, "rank": RANK}
        assert cfg["loras"] == ["A"]
    assert out["list"][0] == out["list"][1]
    for kind in ("greedy", "penalty", "base"):
        tokens, err = out[("port", kind)]
        assert err is None and len(tokens) == 10
        assert tokens == out[("ref", kind)][0], kind
    assert out[("port", "greedy")][0] != out[("port", "base")][0]
    assert "busy: 1 in-flight sequence(s)" in out["busy"]["error"]
    assert "err" not in out["long"][0] and out["long"][1].get("f") == "length"
    assert out["unloaded"] == {"ok": True, "name": "A"}
    assert out["after"] == ([], "adapter 'A' not loaded here")
    assert out["card_after"] == []
    assert out["missing"]["error"] == "\"adapter 'A' not loaded\""


def test_worker_refuses_adapters_without_slots_and_parses_the_cli():
    with pytest.raises(ValueError, match="max_loras=0"):
        TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                    lora_adapters={"A": "/nonexistent.npz"})
    from dynamo_tpu_torch.engine.worker import build_arg_parser

    args = build_arg_parser().parse_args(
        ["--max-loras", "4", "--lora-rank", "16", "--lora", "A=/a.npz",
         "--lora", "B=/b.npz"])
    assert (args.max_loras, args.lora_rank, args.lora) == (
        4, 16, ["A=/a.npz", "B=/b.npz"])


# -- the frontend's adapter routing --------------------------------------------


def test_manager_resolves_adapters_from_both_packages_cards(params, run,
                                                            tmp_path):
    """The port's ModelWatcher records each card's `loras` per instance: a
    port worker's card and a JAX worker's card (each after a load through
    its worker). `resolve` maps an adapter to its base model, an unknown
    name to nothing; `list_adapters` feeds /v1/models; deleting the
    instance drops its adapters."""
    path = _adapter_file(tmp_path, "A", CFG, tt.LORA_TARGETS, RANK, 1)
    rc = dict(max_loras=2, lora_rank=RANK, **RUNNER)

    async def go():
        rt = await DistributedRuntime(_port_rt()).start()
        ref_rt = await RefRuntime(_ref_rt()).start()
        worker = TorchWorker(CFG, RunnerConfig(**rc), device="cpu",
                             params=params_from_numpy(params, CFG,
                                                      device="cpu"))
        ref = TpuWorker(ref_rt, model_name="tiny-test",
                        runner_config=JRunnerConfig(**rc), warmup=False)
        ref.model_config = CFG

        async def shared():
            return params, None

        ref._resolve_params = shared
        manager = ModelManager()
        watcher = ModelWatcher(rt, manager, router_mode="round_robin")
        try:
            worker.start()
            await worker.serve(rt)
            await ref.start()
            await worker.load_adapter("P", path)
            await ref._do_lora_load("J", path)
            port_key = f"v1/mdc/dynamo/backend/generate/{worker.instance_id}"
            ref_key = f"v1/mdc/dynamo/backend/generate/{ref.instance_id}"
            await watcher._handle_put(port_key, worker.card.to_wire())
            await watcher._handle_put(ref_key, ref.card.to_wire())
            entry = manager.get(CFG.name)
            got = {"resolve": [manager.resolve(n) for n in (
                       CFG.name, "P", "J", "nope")],
                   "adapters": manager.list_adapters(),
                   "instances": (entry.lora_instances("P"),
                                 entry.lora_instances("J"))}
            await watcher._handle_delete(ref_key)
            got["after"] = manager.list_adapters()
            await watcher.close()
            return got, entry, worker.instance_id, ref.instance_id
        finally:
            await worker.shutdown()
            await ref.close()
            await rt.shutdown()
            await ref_rt.shutdown()

    got, entry, port_id, ref_id = run(go(), timeout=120)
    assert got["resolve"] == [(entry, None), (entry, "P"), (entry, "J"),
                              (None, None)]
    assert got["adapters"] == [("J", CFG.name), ("P", CFG.name)]
    assert got["instances"] == ({port_id}, {ref_id})
    assert got["after"] == [("P", CFG.name)]


@pytest.mark.parametrize("mode", ["round_robin", "kv"])
def test_router_engines_send_adapter_requests_only_where_loaded(
        params, run, tmp_path, mode):
    """Two port workers, the adapter loaded on one: every adapter request
    of RouterEngine / KvRouterEngine (with the manager's lookup) lands
    there, base requests may go anywhere, and an adapter no instance holds
    fails with the reference's error."""
    path = _adapter_file(tmp_path, "A", CFG, tt.LORA_TARGETS, RANK, 1)
    rc = dict(max_loras=2, lora_rank=RANK, **RUNNER)

    async def go():
        rt = await DistributedRuntime(_port_rt()).start()
        shared = params_from_numpy(params, CFG, device="cpu")
        workers = [TorchWorker(CFG, RunnerConfig(**rc), device="cpu",
                               params=shared) for _ in range(2)]
        router = None
        try:
            for w in workers:
                w.start()
                await w.serve(rt)
            await workers[1].load_adapter("A", path)
            instance_loras = {w.instance_id: list(
                w.card.runtime_config.get("loras", [])) for w in workers}

            def lookup(name):
                return {i for i, ls in instance_loras.items() if name in ls}

            router = PushRouter(rt.namespace("dynamo").component("backend")
                                .endpoint("generate").client(),
                                mode="round_robin")
            await router.client.start()
            while len(router.available()) < 2:
                await asyncio.sleep(0.01)
            engine = (RouterEngine(router, lora_instances=lookup)
                      if mode == "round_robin" else
                      KvRouterEngine(router, KvScheduler(),
                                     lora_instances=lookup))
            before = [w.scheduler.stats.prefill_tokens for w in workers]
            prompt = list(range(3, 20))
            for i in range(4):
                async with contextlib.aclosing(engine.generate(_request(
                        f"a{i}", prompt, 4, lora_name="A"))) as s:
                    outs = [o async for o in s]
                assert outs[-1].error is None
            served = [w.scheduler.stats.prefill_tokens - b
                      for w, b in zip(workers, before)]
            with pytest.raises(NoInstancesAvailable):
                async with contextlib.aclosing(engine.generate(_request(
                        "x", prompt, 4, lora_name="B"))) as s:
                    async for _ in s:
                        pass
            return served
        finally:
            if router is not None:
                await router.client.close()
            for w in workers:
                await w.shutdown()
            await rt.shutdown()

    served = run(go(), timeout=120)
    assert served[0] == 0 and served[1] > 0
