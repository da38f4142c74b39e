"""DeepSeek checkpoints and the data plane over MLA's latent pool in the
port, held against the JAX package on the CPU (the configs and params of
tests/test_torch_mla.py; 127.0.0.1 only, mem planes, no processes).

  * checkpoints: the port's `save_params` is read bit for bit by the
    reference's `load_params` and the reverse, in the V2 shape (its rope
    rows permuted on the way) and the V3 shape (the identity), tied and
    untied; `hf_config_dict` equals the reference's; a mis-shaped tensor
    raises naming it and a missing one names it; `TorchWorker(model_path=)`
    serves a DeepSeek directory as it serves the same params given
    directly;
  * the transfer plane: the runner's gather (`gather_pages_device` ->
    `bundle_to_host`) equals the reference's `gather_kv_blocks` on the same
    latent pool bit for bit, and the staged scatter writes the pages back
    bit for bit;
  * between port workers over the latent pool, a `kv_pull` decode (the
    host relay, link dcn) and a `--mode comesh` handoff (the in-process
    bridge, link ici) each emit the aggregated greedy stream, the decode
    worker prefilling nothing;
  * the KVBM: offload through G2 into G3 and G4, a G1 clear, then onboard:
    the stream equals the cold run and only the prompt's
    last 2 tokens are computed; the tier specs of both runners' layouts
    agree, `reslice` at kv_dims 1 is bit-exact, and the G3 file and G4
    blobs are byte-equal across the packages.

Tolerance 0 throughout: bits, bytes and token ids.
"""

import asyncio
import contextlib
import dataclasses
import json
import time
import uuid

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import block_manager as ref_bm
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.models import checkpoint as ref_ckpt
from dynamo_tpu.models import get_config
from dynamo_tpu.ops.block_copy import gather_kv_blocks
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch import block_manager as port_bm
from dynamo_tpu_torch.engine import (
    InferenceScheduler,
    ModelRunner,
    RunnerConfig,
    TorchWorker,
)
from dynamo_tpu_torch.engine.ici_transfer import IciKvBridge
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.llm.engine import RouterEngine
from dynamo_tpu_torch.llm.prefill_router import PrefillPool, PrefillRouterEngine
from dynamo_tpu_torch.models import checkpoint as port_ckpt
from dynamo_tpu_torch.models import get_config as t_get_config
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.models.safetensors import save_file
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.push_router import PushRouter
from test_torch_mla import CONFIGS, RUNNER, _cast, _params

BF16 = {name: dataclasses.replace(cfg, dtype="bfloat16")
        for name, cfg in CONFIGS.items()}
PROMPTS = (list(range(30, 47)), list(range(60, 75)))  # 17 and 15 tokens
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def params():
    return {name: _params(cfg) for name, cfg in CONFIGS.items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


# -- checkpoints -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_checkpoints_round_trip_bit_exact_across_packages(tmp_path, params,
                                                           name):
    """bf16 params written by each package and read by the other: every
    leaf bit for bit (the reference's zero dense MLP leaves of MoE layers
    aside, which the port drops). The V2 shape permutes the rope rows of
    the written projections, the V3 shape keeps them."""
    cfg = BF16[name]
    tree = _cast(params[name], jnp.bfloat16)
    model = params_from_numpy(tree, cfg, device="cpu")
    port_ckpt.save_params(model, cfg, str(tmp_path / "port"))
    ref_ckpt.save_params(tree, cfg, str(tmp_path / "ref"))
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "ref" / "config.json").read_text()))
    theirs = ref_ckpt.load_params(str(tmp_path / "port"), cfg)
    mine = port_ckpt.load_params(str(tmp_path / "ref"), cfg, device="cpu")
    for leaf in ("embed", "final_norm") + (
            () if cfg.tie_embeddings else ("lm_head",)):
        np.testing.assert_array_equal(_ref_bits(theirs[leaf]),
                                      _bits(getattr(model, leaf)), leaf)
        np.testing.assert_array_equal(_bits(getattr(mine, leaf)),
                                      _bits(getattr(model, leaf)), leaf)
    for i, layer in enumerate(model.layers):
        assert sorted(mine.layers[i].keys()) == sorted(layer.keys())
        for leaf in layer.keys():
            np.testing.assert_array_equal(_bits(mine.layers[i][leaf]),
                                          _bits(layer[leaf]), leaf)
            np.testing.assert_array_equal(
                _ref_bits(theirs["layers"][i][leaf]), _bits(layer[leaf]),
                leaf)
    # the rope rows as written: HF's interleaved order for V2, ours for V3
    with port_ckpt.ShardReader(str(tmp_path / "port")) as reader:
        kv_a = reader.get("model.layers.0.self_attn.kv_a_proj_with_mqa."
                          "weight")
        rope_rows = kv_a[cfg.mla_kv_lora_rank:].t()
    w_kr = model.layers[0]["w_kr"]
    v3 = cfg.mla_q_lora_rank > 0
    assert torch.equal(rope_rows, w_kr) == v3
    perm = port_ckpt._rope_perm(cfg.mla_rope_head_dim)
    assert torch.equal(rope_rows[:, perm], w_kr) != v3


@pytest.mark.parametrize("name", ["tiny-mla-test", "deepseek-v2-lite",
                                  "deepseek-v3", "tiny-ds", "v3"])
def test_hf_config_dict_equals_the_reference(name):
    cfg = CONFIGS.get(name) or t_get_config(name)
    want = ref_ckpt.hf_config_dict(CONFIGS.get(name) or get_config(name))
    assert port_ckpt.hf_config_dict(cfg) == want
    assert dataclasses.asdict(port_ckpt.config_from_hf(want, name="m")) \
        == dataclasses.asdict(ref_ckpt.config_from_hf(want, name="m"))


def test_mis_shaped_or_missing_tensors_raise_naming_them(tmp_path, params):
    cfg = CONFIGS["tiny-ds"]
    model = params_from_numpy(params["tiny-ds"], cfg, device="cpu")
    port_ckpt.save_params(model, cfg, str(tmp_path))
    with port_ckpt.ShardReader(str(tmp_path)) as reader:
        tensors = {n: reader.get(n).clone() for n in reader.names()}
    name = "model.layers.1.self_attn.kv_b_proj.weight"
    bad = dict(tensors, **{name: tensors[name][:-1]})
    save_file(bad, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match=f"{name} has shape"):
        port_ckpt.load_params(str(tmp_path), cfg, device="cpu")
    gone = "model.layers.2.mlp.shared_experts.down_proj.weight"
    save_file({n: t for n, t in tensors.items() if n != gone},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match=gone):
        port_ckpt.load_params(str(tmp_path), cfg, device="cpu")
    with pytest.raises(ValueError, match="dedicated DeepSeek path"):
        port_ckpt.build_mapping(cfg)


class Stream:
    def __init__(self):
        self.tokens: list = []
        self.finish = None

    def emit(self, out) -> None:
        self.tokens += out.token_ids
        if out.finish_reason is not None:
            self.finish = out.finish_reason


def _greedy(sched, prompt, rid: str, limit: int = 500) -> list:
    """One greedy request, the scheduler's loop body pumped on this
    thread."""
    stream = Stream()
    sched.submit(protocols.PreprocessedRequest(
        request_id=rid, token_ids=list(prompt),
        sampling=protocols.SamplingOptions(max_tokens=MAX_TOKENS,
                                           temperature=0.0),
        stop=protocols.StopConditions(ignore_eos=True)), stream.emit)
    for _ in range(limit):
        if stream.finish is not None:
            assert stream.finish == "length"
            return stream.tokens
        sched._drain_control()
        sched._drain_incoming()
        if not sched._step():
            sched._drain_gap()
    raise AssertionError("the scheduler stalled")


def test_worker_serves_a_deepseek_directory(tmp_path, params):
    """`--model-path` on a DeepSeek-V2 directory: the worker's config is
    the reference's reading of it (bf16, named after the directory), its
    card names the directory, and its greedy stream equals a worker given
    the same bf16 params directly."""
    cfg = CONFIGS["tiny-ds"]
    path = tmp_path / "deepseek-tiny"
    port_ckpt.save_params(params_from_numpy(params["tiny-ds"], cfg,
                                            device="cpu"), cfg, str(path))
    worker = TorchWorker(model_path=str(path), device="cpu",
                         runner_config=RunnerConfig(**RUNNER))
    want_cfg = ref_ckpt.config_from_checkpoint(str(path))
    assert dataclasses.asdict(worker.model_config) == dataclasses.asdict(
        want_cfg)
    assert worker.model_config.is_mla and worker.model_config.n_experts
    assert worker.card.name == "deepseek-tiny"
    direct = TorchWorker(worker.model_config, RunnerConfig(**RUNNER),
                         device="cpu", params=params_from_numpy(
                             _cast(params["tiny-ds"], jnp.bfloat16),
                             worker.model_config, device="cpu"))
    got = _greedy(worker.scheduler, PROMPTS[0], "dir")
    want = _greedy(direct.scheduler, PROMPTS[0], "direct")
    assert got == want and len(got) == MAX_TOKENS


# -- the transfer plane ------------------------------------------------------------


def _filled(cfg, seed=0, **runner) -> ModelRunner:
    runner = ModelRunner(cfg, RunnerConfig(**dict(RUNNER, **runner)),
                         device="cpu")
    runner.kv_cache.copy_(torch.from_numpy(np.random.default_rng(
        seed).standard_normal(runner.kv_cache.shape).astype(np.float32)))
    return runner


PAGES = [5, 2, 9, 17, 3, 11, 40, 41, 12]


def test_page_io_equals_the_reference_gather():
    """Latent pages out through the runner's transfer path and back into
    fresh pages of another runner, bit for bit; the bundle equals the
    reference's gather of the same pool."""
    cfg = CONFIGS["tiny-ds"]
    src = _filled(cfg)
    bundle = src.bundle_to_host(src.gather_pages_device(PAGES))
    want = np.asarray(gather_kv_blocks(jnp.asarray(src.kv_cache.numpy()),
                                       jnp.asarray(PAGES, jnp.int32)))
    assert tuple(bundle.shape) == want.shape == (
        len(PAGES), cfg.n_layers, 1, RUNNER["page_size"], 1,
        cfg.kv_cache_head_dim)
    np.testing.assert_array_equal(bundle.numpy().view(np.uint32),
                                  want.view(np.uint32))
    dst = _filled(cfg, seed=1)
    fresh = [60, 61, 70, 71, 72, 80, 81, 90, 91]
    dst.scatter_pages(fresh, dst.stage_bundle(bundle))
    assert torch.equal(dst.kv_cache[:, :, fresh], src.kv_cache[:, :, PAGES])


def _rt_config() -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="mem",
                         discovery_path=uuid.uuid4().hex,
                         request_plane="mem", event_plane="mem",
                         system_enabled=False, lease_ttl_secs=10.0)


def _request(tokens):
    return protocols.PreprocessedRequest(
        request_id=uuid.uuid4().hex, token_ids=list(tokens),
        sampling=protocols.SamplingOptions(max_tokens=MAX_TOKENS,
                                           temperature=0.0, seed=7),
        stop=protocols.StopConditions(ignore_eos=True))


async def _collect(engine, request) -> list:
    toks = []
    async with contextlib.aclosing(engine.generate(request)) as stream:
        async for out in stream:
            assert out.error is None, out.error
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                break
    return toks


@pytest.mark.parametrize("link", ["dcn", "ici"])
def test_disaggregated_streams_equal_aggregated(run, params, link):
    """A prefill worker and a decode worker of the DeepSeek stack, with the
    pipeline a frontend builds: without a bridge the decode worker pulls
    over `kv_pull` (dcn), with one (`--mode comesh`) through it (ici). Each
    prompt's disaggregated stream equals its aggregated one, the decode
    worker prefills nothing, and every transfer is released."""
    cfg = CONFIGS["tiny-ds"]

    async def go():
        rt = await DistributedRuntime(_rt_config()).start()
        bridge = IciKvBridge() if link == "ici" else None
        shared = params_from_numpy(params["tiny-ds"], cfg, device="cpu")
        workers = [TorchWorker(cfg, RunnerConfig(**RUNNER), device="cpu",
                               params=shared, mode=mode, component=comp,
                               ici_bridge=bridge)
                   for mode, comp in (("prefill", "prefill"),
                                      ("decode", "backend"))]
        routers = []
        try:
            for w in workers:
                w.start()
                await w.serve(rt)
            for component in ("backend", "prefill"):
                router = PushRouter(rt.namespace("dynamo")
                                    .component(component)
                                    .endpoint("generate").client(),
                                    mode="round_robin")
                await router.client.start()
                routers.append(router)
            inner = RouterEngine(routers[0])
            pool = PrefillPool(router=routers[1],
                               instances={workers[0].instance_id})
            disagg = PrefillRouterEngine(inner, lambda: pool)
            prefill, decode = workers
            agg = [await _collect(inner, _request(p)) for p in PROMPTS]
            prefilled = decode.scheduler.stats.prefill_tokens
            dis = []
            for prompt in PROMPTS:
                for w in workers:  # both pools start empty
                    w.scheduler.run_in_step(w.scheduler.pool.clear).get(
                        timeout=30)
                dis.append(await _collect(disagg, _request(prompt)))
            await asyncio.sleep(0.05)
            return (agg, dis, decode.scheduler.stats.prefill_tokens
                    - prefilled, [p["link"] for p in decode.pulls],
                    len(prefill.transfers), decode.runner.kv_layout())
        finally:
            for router in routers:
                await router.client.close()
            for w in workers:
                await w.shutdown()
            await rt.shutdown()

    agg, dis, prefilled, links, parked, layout = run(go(), timeout=120)
    assert dis == agg and all(len(t) == MAX_TOKENS for t in dis)
    assert prefilled == 0  # onboarded, never recomputed
    assert links == [link] * len(PROMPTS)
    assert parked == 0
    assert (layout["kv_dims"], layout["kv_heads"]) == (1, 1)


# -- the KVBM ---------------------------------------------------------------------


def _served(sched, prompt, rid, timeout=60.0) -> list:
    """One request's tokens, once the running scheduler has released it
    (its blocks register, and queue their offload, at release)."""
    outs, done = [], []

    def emit(o):
        outs.append(o)
        if o.finish_reason is not None:
            done.append(1)

    sched.submit(protocols.PreprocessedRequest(
        request_id=rid, token_ids=list(prompt),
        sampling=protocols.SamplingOptions(max_tokens=MAX_TOKENS,
                                           temperature=0.0),
        stop=protocols.StopConditions(ignore_eos=True)), emit)
    deadline = time.monotonic() + timeout
    while not done or sched._waiting or any(
            s is not None for s in sched._slots):
        assert time.monotonic() < deadline, "request was not released"
        time.sleep(0.001)
    return [t for o in outs for t in o.token_ids]


def test_kvbm_offload_clear_onboard(tmp_path, params):
    """An 18-token prompt (4 full blocks of 4) served cold, its blocks
    offloaded through a 2-block G2 and a 1-block G3 into G4, G1 cleared,
    then served again: 4 blocks onboard, only the last 2 tokens are
    computed, and the stream equals the cold one."""
    cfg = CONFIGS["tiny-ds"]
    runner = ModelRunner(cfg, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params["tiny-ds"], cfg,
                                                  device="cpu"))
    spec = port_bm.BlockLayoutSpec.from_runner_layout(runner.kv_layout())
    assert spec.block_shape == (cfg.n_layers, 1, 4, 1, cfg.kv_cache_head_dim)
    mgr = port_bm.KvBlockManager(port_bm.KvbmConfig(
        host_blocks=2, disk_blocks=1, disk_path=str(tmp_path / "g3.bin"),
        object_store_root=str(tmp_path / "g4"), admission=False), spec)
    sched = InferenceScheduler(runner, kvbm=mgr)
    sched.start()
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size,
                                               18).tolist()
    try:
        cold = _served(sched, prompt, "cold")
        deadline = time.monotonic() + 30
        while mgr.stats.offloaded < 4:
            assert time.monotonic() < deadline, "blocks were not offloaded"
            mgr.flush(1.0)
            time.sleep(0.01)
        prefilled = sched.stats.prefill_tokens
        sched.run_in_step(sched.pool.clear).get(timeout=30)
        warm = _served(sched, prompt, "warm")
        assert sched.error is None
        stats = dataclasses.asdict(mgr.stats)
        computed = sched.stats.prefill_tokens - prefilled
        onboarded = sched.stats.kvbm_onboarded_blocks
    finally:
        sched.stop()
        mgr.close()
    assert warm == cold and len(cold) == MAX_TOKENS
    assert onboarded == 4 and computed == 2
    # a run longer than G2's room reads from G4, each hit promoted up the
    # tiers as it goes (the reference's semantics)
    assert stats["offloaded"] == 4 and stats["onboard_hits_object"] > 0
    assert sum(stats[f"onboard_hits_{tier}"]
               for tier in ("host", "disk", "object")) == 4


def _runner_specs(name, dtype):
    cfg = dataclasses.replace(CONFIGS[name], dtype=dtype)
    rc = dict(RUNNER, num_pages=8)
    mine = ModelRunner(cfg, RunnerConfig(**rc), device="cpu").kv_layout()
    theirs = JRunner(cfg, JRunnerConfig(**rc), make_mesh(MeshConfig()),
                     seed=0).kv_layout()
    return (ref_bm.BlockLayoutSpec.from_runner_layout(theirs),
            port_bm.BlockLayoutSpec.from_runner_layout(mine))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tier_blocks_reslice_and_persist_alike_at_kv_dims_1(tmp_path, dtype):
    """Both runners' latent layouts give the same tier spec (kv_dims 1,
    one head of dc + rhd); seeded blocks reslice bit for bit, the G3 file
    and the G4 blobs the two managers write are byte-equal, and the port
    reads its blocks back from each tier bit for bit."""
    rspec, pspec = _runner_specs("tiny-mla-test", dtype)
    assert pspec.to_wire() == rspec.to_wire()
    assert pspec.block_shape == rspec.block_shape == (2, 1, 4, 1, 40)
    rng = np.random.default_rng(9)
    words = rng.standard_normal((5,) + pspec.block_shape).astype(np.float32)
    if dtype == "bfloat16":
        words = np.asarray(words, ml_dtypes.bfloat16)
        port_blocks = torch.from_numpy(words.view(np.int16)).view(
            torch.bfloat16)
    else:
        port_blocks = torch.from_numpy(words.copy())
    got = port_bm.reslice(port_blocks, pspec, pspec)
    want = ref_bm.reslice(words, rspec, rspec)
    np.testing.assert_array_equal(_bits(got), _ref_bits(want))
    managers = []
    for name, mod, spec in (("ref", ref_bm, rspec), ("port", port_bm, pspec)):
        root = tmp_path / name
        managers.append(mod.KvBlockManager(mod.KvbmConfig(
            host_blocks=1, disk_blocks=2, disk_path=str(root / "g3.bin"),
            object_store_root=str(root / "g4"), admission=False), spec))
    rm, pm = managers
    try:
        for h in range(1, 6):
            rm._offload_sink(h, words[h - 1], h - 1 or None)
            pm._offload_sink(h, port_blocks[h - 1], h - 1 or None)
        assert pm.usage() == rm.usage()
        rm.disk.arena._slab.flush()
        pm.disk.arena._slab.flush()
        assert ((tmp_path / "port" / "g3.bin").read_bytes()
                == (tmp_path / "ref" / "g3.bin").read_bytes())
        blobs = {}
        for name in ("port", "ref"):
            root = tmp_path / name / "g4"
            blobs[name] = sorted(str(p.relative_to(root))
                                 for p in root.rglob("*") if p.is_file())
        assert blobs["port"] == blobs["ref"] and blobs["port"]
        blobs = blobs["port"]
        for blob in blobs:
            assert ((tmp_path / "port" / "g4" / blob).read_bytes()
                    == (tmp_path / "ref" / "g4" / blob).read_bytes())
        back = pm.read_blocks([1, 2, 3, 4, 5])
        np.testing.assert_array_equal(_bits(back), _bits(port_blocks))
    finally:
        rm.close()
        pm.close()
