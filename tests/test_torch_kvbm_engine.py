"""The KVBM tiers wired into the port's engine, held against the JAX engine
with the reference's `KvBlockManager` (tiny-test shapes, CPU, page size 4).

Two pools: bf16 (tiny-test in bfloat16) and int8 (tiny-test in float32 at
head_dim 128, the int8 pool's gate), with the same weights in both packages
(`params_from_numpy`). For each:

  * offload then onboard: a prompt served cold, its blocks offloaded to G2,
    the G1 prefix cache cleared, the prompt served again: at least 2 blocks
    onboard, and the greedy tokens equal the cold run's and the JAX
    engine's, cold and warm, under the reference's KVBM (tolerance 0: token
    ids);
  * tier blocks equal across packages: a seeded pool scattered into both
    runners, the same hashes offloaded through each package's gather: the
    G2 blocks, the G3 file and the G4 blobs are byte-equal (bf16 as bit
    patterns, int8 as packed bytes).

Then the port alone: a G2 too small for the prompt cascades to G3 and the
blocks are promoted back on read; the port onboards int8 blobs that the
reference's engine wrote to G4; and without a KVBM (`kvbm=None`) the
scheduler's streams and prefill counts are what they were.
"""

import asyncio
import dataclasses
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import block_manager as ref_bm
from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu.runtime.flight_recorder import get_recorder as ref_recorder
from dynamo_tpu_torch import block_manager as port_bm
from dynamo_tpu_torch.engine import InferenceScheduler, ModelRunner, RunnerConfig
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime.flight_recorder import (
    get_recorder as port_recorder,
)
from dynamo_tpu_torch.tokens import compute_block_hashes

CONFIGS = {
    "bf16": get_config("tiny-test"),
    "int8": dataclasses.replace(get_config("tiny-test"), dtype="float32",
                                head_dim=128),
}
KV_DTYPE = {"bf16": "model", "int8": "int8"}
RUNNER = dict(page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
PROMPT = np.random.default_rng(3).integers(1, 512, 18).tolist()  # 4 blocks
MAX_TOKENS = 6


def _runner_config(kind: str) -> dict:
    return dict(RUNNER, kv_dtype=KV_DTYPE[kind])


def _serve(sched, request, timeout=60.0, record_id=None) -> list:
    """One request's tokens, returned once the scheduler has released it
    (its blocks register, and queue their offload, at release)."""
    done = threading.Event()
    outs = []

    def emit(o):
        outs.append(o)
        if o.finish_reason is not None:
            done.set()

    sched.submit(request, emit, record_id=record_id)
    assert done.wait(timeout), "stream did not finish"
    deadline = time.monotonic() + timeout
    while sched._waiting or any(s is not None for s in sched._slots):
        assert time.monotonic() < deadline, "sequence was not released"
        time.sleep(0.001)
    return [t for o in outs for t in o.token_ids]


def _port_request(rid: str) -> PreprocessedRequest:
    return PreprocessedRequest(
        request_id=rid, token_ids=list(PROMPT),
        sampling=SamplingOptions(max_tokens=MAX_TOKENS, temperature=0.0),
        stop=StopConditions(ignore_eos=True))


def _jax_request(rid: str) -> JRequest:
    return JRequest(
        request_id=rid, token_ids=list(PROMPT),
        sampling=JSampling(max_tokens=MAX_TOKENS, temperature=0.0),
        stop=JStop(ignore_eos=True))


def _offloaded(mgr, n: int, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while mgr.stats.offloaded < n:
        assert time.monotonic() < deadline, "blocks were not offloaded"
        mgr.flush(1.0)
        time.sleep(0.01)


def _cold_then_warm(sched, mgr, make_request, recorder) -> dict:
    """Serve the prompt, wait for its 4 blocks to offload, clear G1, serve
    it again, its flight-recorder timeline open."""
    cold = _serve(sched, make_request("cold"))
    _offloaded(mgr, 4)
    prefilled = sched.stats.prefill_tokens
    sched.run_in_step(sched.pool.clear).get(timeout=30.0)
    rid = f"warm-{id(sched)}"
    recorder.start(rid)
    warm = _serve(sched, make_request("warm"), record_id=rid)
    timeline = recorder.finish(rid)
    return {"cold": cold, "warm": warm,
            "onload": [e for e in timeline.events
                       if e["event"] == "kvbm_onload"],
            "onboarded": sched.stats.kvbm_onboarded_blocks,
            "warm_prefill": sched.stats.prefill_tokens - prefilled,
            "stats": dataclasses.asdict(mgr.stats)}


@pytest.fixture(scope="module")
def params():
    return {kind: jax.device_get(j_init(jax.random.PRNGKey(0), cfg))
            for kind, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def engines(params, tmp_path_factory):
    """Each package's cold / warm run per pool. The reference's int8 KVBM
    holds 2 G2 blocks over a G4 root, so half its blocks land in G4 as the
    reference writes them (its bf16 G4 never reads back: G2 holds all)."""
    root = tmp_path_factory.mktemp("kvbm_engine")
    out = {}
    for kind, cfg in CONFIGS.items():
        runner = ModelRunner(cfg, RunnerConfig(**_runner_config(kind)),
                             device="cpu",
                             params=params_from_numpy(params[kind], cfg,
                                                      device="cpu"))
        mgr = port_bm.KvBlockManager(
            port_bm.KvbmConfig(host_blocks=16, admission=False),
            port_bm.BlockLayoutSpec.from_runner_layout(runner.kv_layout()))
        sched = InferenceScheduler(runner, kvbm=mgr)
        sched.start()
        try:
            port_run = _cold_then_warm(sched, mgr, _port_request,
                                       port_recorder())
            assert sched.error is None
        finally:
            sched.stop()
            mgr.close()
        j_runner = JRunner(cfg, JRunnerConfig(**_runner_config(kind)),
                           make_mesh(MeshConfig()), params=params[kind])
        g4 = str(root / f"ref_g4_{kind}") if kind == "int8" else None
        j_mgr = ref_bm.KvBlockManager(
            ref_bm.KvbmConfig(host_blocks=2 if g4 else 16,
                              object_store_root=g4, admission=False),
            ref_bm.BlockLayoutSpec.from_runner_layout(j_runner.kv_layout()))
        j_sched = JScheduler(j_runner, kvbm=j_mgr)
        j_sched.start()
        try:
            ref_run = _cold_then_warm(j_sched, j_mgr, _jax_request,
                                      ref_recorder())
        finally:
            j_sched.stop()
            j_mgr.close()
        out[kind] = {"port": port_run, "ref": ref_run, "ref_g4": g4}
    return out


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_offload_then_onboard_matches_jax(engines, kind):
    port_run, ref_run = engines[kind]["port"], engines[kind]["ref"]
    assert port_run["onboarded"] >= 2
    assert port_run["onboarded"] == ref_run["onboarded"] == 4
    assert port_run["stats"]["onboard_hits_host"] == 4
    # the warm run computed only the prompt's last 2 tokens
    assert port_run["warm_prefill"] == ref_run["warm_prefill"] == 2
    assert len(port_run["cold"]) == MAX_TOKENS
    assert port_run["warm"] == port_run["cold"]
    assert port_run["cold"] == ref_run["cold"] == ref_run["warm"]
    # the kvbm_onload event: the reference's keys, and the port's onboard
    # milliseconds (a logged difference, ROADMAP Queue 3)
    (mine,), (theirs,) = port_run["onload"], ref_run["onload"]
    assert {k: mine[k] for k in ("blocks", "tokens")} == {
        k: theirs[k] for k in ("blocks", "tokens")} == {"blocks": 4,
                                                        "tokens": 16}
    assert set(mine) - set(theirs) == {"ms"} and mine["ms"] > 0


# -- tier blocks across packages ---------------------------------------------

PAGES = [3, 9, 5, 12, 7, 2]  # pages the seeded blocks are written to
HASHES = [0x1111 * (i + 1) for i in range(len(PAGES))]


def _seeded_bundle(kind: str, spec) -> np.ndarray:
    """Storage words of len(PAGES) blocks: bf16 bits, or packed int8 bytes
    whose scale rows repeat one bf16 value per token over 128 lanes."""
    rng = np.random.default_rng(21)
    n = len(PAGES)
    if kind == "bf16":
        x = rng.standard_normal((n,) + spec.block_shape).astype(np.float32)
        return np.asarray(x, ml_dtypes.bfloat16).view(np.uint16)
    tokens = spec.n_layers * spec.kv_dims * spec.page_size
    nv = tokens * spec.kv_head_count * spec.head_dim
    values = rng.integers(0, 256, (n, nv)).astype(np.uint8)
    scales = np.asarray(rng.uniform(0.01, 2.0, (n, tokens)),
                        ml_dtypes.bfloat16).view(np.uint16)
    lanes = np.repeat(scales[..., None], spec.scale_lanes, axis=-1)
    return np.concatenate([values, lanes.reshape(n, -1).view(np.uint8)],
                          axis=1)


def _port_tensor(words: np.ndarray) -> torch.Tensor:
    if words.dtype == np.uint16:
        return torch.from_numpy(words.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(words.copy())


def _bits(block) -> bytes:
    if isinstance(block, torch.Tensor):
        if block.dtype == torch.bfloat16:
            block = block.view(torch.int16)
        return block.contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(block)).tobytes()


@pytest.fixture(scope="module", params=["bf16", "int8"])
def tiers(request, tmp_path_factory):
    """The same seeded blocks offloaded through each package's runner
    gather into 2 G2 blocks, 2 G3 blocks and a G4 root."""
    kind = request.param
    cfg = CONFIGS[kind]
    root = tmp_path_factory.mktemp(f"tiers_{kind}")
    runner = ModelRunner(cfg, RunnerConfig(**_runner_config(kind)),
                         device="cpu")
    j_runner = JRunner(cfg, JRunnerConfig(**_runner_config(kind)),
                       make_mesh(MeshConfig()), seed=0)
    spec = port_bm.BlockLayoutSpec.from_runner_layout(runner.kv_layout())
    words = _seeded_bundle(kind, spec)
    ids = np.asarray(PAGES, np.int32)
    runner.scatter_pages(ids, _port_tensor(words))
    j_runner.scatter_pages(
        ids, words.view(ml_dtypes.bfloat16) if kind == "bf16" else words)
    page_of = dict(zip(HASHES, PAGES))
    mgrs = {}
    for name, bm, r in (("port", port_bm, runner), ("ref", ref_bm, j_runner)):
        mgr = bm.KvBlockManager(
            bm.KvbmConfig(host_blocks=2, disk_blocks=2,
                          disk_path=str(root / name / "g3.bin"),
                          object_store_root=str(root / name / "g4"),
                          admission=False),
            bm.BlockLayoutSpec.from_runner_layout(r.kv_layout()))
        kw = {"to_host": r.bundle_to_host} if name == "port" else {}
        mgr.attach_engine(
            lookup_pages=lambda hs: [page_of.get(h) for h in hs],
            gather=r.gather_pages_device, run_in_step=None, **kw)
        mgr.notify_stored(HASHES, None)
        assert mgr.flush(30.0)
        mgrs[name] = mgr
    yield {"kind": kind, "root": root, "words": words, **mgrs}
    for mgr in mgrs.values():
        mgr.close()


def test_offloaded_blocks_equal_across_packages(tiers):
    port, ref = tiers["port"], tiers["ref"]
    assert port.stats.offloaded == ref.stats.offloaded == len(HASHES)
    assert port.offload.dropped == ref.offload.dropped == 0
    for h in HASHES[-2:]:  # G2 holds the last two
        assert port.host.contains(h) and ref.host.contains(h)
        assert _bits(port.host.get(h)) == _bits(ref.host.get(h))
    i = HASHES.index(HASHES[-1])
    assert _bits(port.host.get(HASHES[-1])) == tiers["words"][i].tobytes()


def test_g3_file_and_g4_blobs_equal_across_packages(tiers):
    root = tiers["root"]
    for name in ("port", "ref"):
        tiers[name].disk.arena._slab.flush()
    assert ((root / "port" / "g3.bin").read_bytes()
            == (root / "ref" / "g3.bin").read_bytes())
    blobs = {name: sorted(p.relative_to(root / name / "g4")
                          for p in (root / name / "g4").rglob("*.npy"))
             for name in ("port", "ref")}
    assert len(blobs["port"]) == 2 and blobs["port"] == blobs["ref"]
    for rel in blobs["port"]:
        assert ((root / "port" / "g4" / rel).read_bytes()
                == (root / "ref" / "g4" / rel).read_bytes())
    # every block reads back from the port's tiers; the reference's bf16
    # G4 blobs do not
    got = tiers["port"].read_blocks(HASHES)
    assert got is not None and _bits(got) == tiers["words"].tobytes()
    assert tiers["port"].stats.onboard_hits_object >= 2
    theirs = tiers["ref"].read_blocks(HASHES)
    assert (theirs is None) == (tiers["kind"] == "bf16")


# -- the port alone ----------------------------------------------------------


def _port_scheduler(params, kind: str, config) -> tuple:
    cfg = CONFIGS[kind]
    runner = ModelRunner(cfg, RunnerConfig(**_runner_config(kind)),
                         device="cpu",
                         params=params_from_numpy(params[kind], cfg,
                                                  device="cpu"))
    mgr = None
    if config is not None:
        mgr = port_bm.KvBlockManager(
            config,
            port_bm.BlockLayoutSpec.from_runner_layout(runner.kv_layout()))
    sched = InferenceScheduler(runner, kvbm=mgr)
    sched.start()
    return sched, mgr


def test_small_g2_cascades_to_g3_and_promotes_back(params, engines,
                                                   tmp_path):
    sched, mgr = _port_scheduler(params, "bf16", port_bm.KvbmConfig(
        host_blocks=2, disk_blocks=8, disk_path=str(tmp_path / "g3.bin"),
        admission=False))
    try:
        run = _cold_then_warm(sched, mgr, _port_request, port_recorder())
        assert run["cold"] == run["warm"] == engines["bf16"]["port"]["cold"]
        assert run["onboarded"] == 4
        assert run["stats"]["onboard_hits_disk"] >= 2
        assert (run["stats"]["onboard_hits_host"]
                + run["stats"]["onboard_hits_disk"]) == 4
        # the blocks read last were promoted back into G2
        hashes = compute_block_hashes(PROMPT, RUNNER["page_size"])
        assert mgr.host.contains(hashes[3]) and mgr.host.contains(hashes[2])
    finally:
        sched.stop()
        mgr.close()


def test_port_onboards_the_references_g4_blobs(params, engines):
    """int8 blobs the JAX engine's KVBM wrote to G4 (its G2 holds 2 of the
    prompt's 4 blocks) are onboarded by a port engine whose own tiers are
    empty."""
    root = engines["int8"]["ref_g4"]
    sched, mgr = _port_scheduler(params, "int8", port_bm.KvbmConfig(
        host_blocks=16, object_store_root=root, admission=False))
    try:
        tokens = _serve(sched, _port_request("from-ref-g4"))
        assert mgr.stats.onboard_hits_object >= 2
        assert sched.stats.kvbm_onboarded_blocks >= 2
        assert mgr.object_store.corrupt_reads == 0
        assert tokens == engines["int8"]["port"]["cold"]
    finally:
        sched.stop()
        mgr.close()


def test_without_kvbm_the_scheduler_is_unchanged(params, engines):
    sched, _ = _port_scheduler(params, "int8", None)
    try:
        assert sched.kvbm is None
        cold = _serve(sched, _port_request("a"))
        sched.run_in_step(sched.pool.clear).get(timeout=30.0)
        again = _serve(sched, _port_request("b"))
        assert cold == again == engines["int8"]["port"]["cold"]
        assert sched.stats.kvbm_onboarded_blocks == 0
        assert sched.stats.prefill_tokens == 2 * len(PROMPT)
    finally:
        sched.stop()


def test_worker_cli_takes_the_references_kvbm_flags():
    from dynamo_tpu.engine.worker import build_arg_parser as ref_parser
    from dynamo_tpu_torch.engine.worker import build_arg_parser

    flags = ["--kvbm-host-blocks", "32", "--kvbm-disk-blocks", "64",
             "--kvbm-disk-path", "/x/g3.bin", "--kvbm-object-store", "/x/g4"]
    names = ("kvbm_host_blocks", "kvbm_disk_blocks", "kvbm_disk_path",
             "kvbm_object_store")
    for argv in ([], flags):
        mine, theirs = build_arg_parser().parse_args(argv), \
            ref_parser().parse_args(argv)
        assert ({n: getattr(mine, n) for n in names}
                == {n: getattr(theirs, n) for n in names})


def test_worker_pins_cache_anchors_and_flushes_at_shutdown(params, run):
    """`generate` leases a request's anchored prefix blocks (a
    `session_pin` event) and prefetches them; `shutdown` flushes the
    offload, then stops the scheduler and closes the tiers."""
    from dynamo_tpu_torch.engine import TorchWorker

    cfg = CONFIGS["bf16"]
    worker = TorchWorker(
        cfg, RunnerConfig(**_runner_config("bf16")), device="cpu",
        params=params_from_numpy(params["bf16"], cfg, device="cpu"),
        kvbm_config=port_bm.KvbmConfig(host_blocks=16, admission=False))
    assert worker.scheduler.kvbm is worker.kvbm
    worker.start()
    body = PreprocessedRequest(
        request_id="anchored", token_ids=list(PROMPT),
        sampling=SamplingOptions(max_tokens=MAX_TOKENS, temperature=0.0),
        stop=StopConditions(ignore_eos=True), cache_anchors=[10],
        cache_ttl=30.0).to_wire()

    async def serve():
        frames = [f async for f in worker.generate(body)]
        sched = worker.scheduler
        # the pages (and their offload) are released after the last frame
        while sched._waiting or any(s is not None for s in sched._slots):
            await asyncio.sleep(0.001)
        await worker.shutdown()
        return frames

    frames = run(serve())
    assert frames[-1]["f"] == "length"
    timeline = port_recorder().get("anchored")
    pins = [e for e in timeline.events if e["event"] == "session_pin"]
    assert pins == [dict(pins[0], blocks=2)]  # 10 // 4 full blocks
    assert worker.kvbm.pinned_blocks() == 2
    # the prompt's 4 blocks offloaded before shutdown stopped the engine
    assert worker.kvbm.stats.offloaded == 4
    assert not worker.scheduler._thread.is_alive()
    assert not worker.kvbm.offload._thread.is_alive()
