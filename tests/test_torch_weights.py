"""The port's weight plane against the JAX package's (`dynamo_tpu/weights/`).

  * the bulk XXH64 equals `xxhash` at every length class (bit-equal);
  * `checkpoint_digest` equals the reference's on a directory the port's
    `save_params` wrote, and moves on a header edit and on a tail edit;
  * `WeightManifest.build(...).to_wire()` equals the reference's for the
    same tiny-test leaves, bf16 included; a corrupt chunk is rejected; the
    bandwidth budget equals the reference's formula over a grid;
  * the weight service and the object store work across the packages in
    both directions (leaves bit-equal after `params_from_numpy`); a missing
    key or a corrupt chunk gives None;
  * a port arrival pulls striped from a port donor and from a JAX
    `TpuWorker` donor and serves greedy streams equal to the donor's; the
    single-peer stream likewise; donor death re-stripes (stub donors, as
    `tests/test_faststart.py` drives the reference), with the reference's
    outcome on the same stubs;
  * the weights keys of the two packages agree for tiny-test and
    llama3-8b.

CPU only, tiny-test, no process spawned, 127.0.0.1 only, unique socket
paths under tmp_path.
"""

import dataclasses
import json
import types
import uuid

import jax
import numpy as np
import pytest
import torch
import xxhash

from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.models import checkpoint as ref_checkpoint
from dynamo_tpu.models import get_config as ref_get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime.config import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu.weights import client as ref_client
from dynamo_tpu.weights import objstore as ref_objstore
from dynamo_tpu.weights import service as ref_service
from dynamo_tpu.weights import striped as ref_striped
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import get_config, params_from_numpy
from dynamo_tpu_torch.models.checkpoint import checkpoint_digest, save_params
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.tokens import xxh64_hexdigest, xxh64_many
from dynamo_tpu_torch.weights import client, objstore, striped
from dynamo_tpu_torch.weights.leaves import to_bytes
from dynamo_tpu_torch.weights.service import serve_in_process

TINY = get_config("tiny-test")
CFG = dataclasses.replace(TINY, dtype="float32")
RUNNER = dict(page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))


def _jax_tree(cfg=TINY, seed: int = 0) -> dict:
    return jax.device_get(j_init(jax.random.PRNGKey(seed), cfg))


def _port_model(tree: dict, cfg=TINY):
    return params_from_numpy(tree, cfg, device="cpu")


def _bits(t: torch.Tensor) -> bytes:
    return to_bytes(t).tobytes()


def _assert_tree_equal(got: dict, tree: dict, cfg=TINY) -> None:
    """Port host tensors by path == the JAX tree after params_from_numpy,
    bit for bit."""
    want = dict(client.flatten_params(_port_model(tree, cfg)))
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype and got[path].shape == t.shape
        assert _bits(got[path]) == _bits(t), path


# -- the bulk XXH64 (tolerance: bit-equal) -------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 63, 64, 97,
                               4 << 20, (4 << 20) + 29])
def test_bulk_xxh64_equals_xxhash(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for seed in (0, 0xD3A10C0DE, 2**64 - 1):
        assert xxh64_many([data], seed)[0] == xxhash.xxh64_intdigest(
            data, seed)
    assert xxh64_hexdigest(data) == xxhash.xxh64_hexdigest(data)


def test_bulk_xxh64_batches_mixed_lengths():
    rng = np.random.default_rng(7)
    bufs = [rng.integers(0, 256, int(n), np.uint8).tobytes()
            for n in rng.integers(0, 3000, 700)]
    bufs += [rng.integers(0, 256, 4096, np.uint8) for _ in range(600)]
    got = xxh64_many(bufs)
    assert got == [xxhash.xxh64_intdigest(bytes(b)) for b in bufs]


# -- checkpoint digests (tolerance: bit-equal) ---------------------------------

def test_checkpoint_digest_equals_the_reference(tmp_path):
    save_params(_port_model(_jax_tree()), TINY, str(tmp_path),
                max_shard_bytes=40_000)
    shards = sorted(tmp_path.glob("*.safetensors"))
    assert len(shards) > 1
    base = checkpoint_digest(str(tmp_path))
    assert base == ref_checkpoint.checkpoint_digest(str(tmp_path))

    def edit(path, offset):
        raw = bytearray(path.read_bytes())
        raw[offset] ^= 0x01
        path.write_bytes(bytes(raw))

    head = shards[0].read_bytes()
    edit(shards[0], 8 + int.from_bytes(head[:8], "little") - 1)  # header
    after_header = checkpoint_digest(str(tmp_path))
    assert after_header != base
    assert after_header == ref_checkpoint.checkpoint_digest(str(tmp_path))
    edit(shards[-1], shards[-1].stat().st_size - 1)  # tail
    after_tail = checkpoint_digest(str(tmp_path))
    assert after_tail not in (base, after_header)
    assert after_tail == ref_checkpoint.checkpoint_digest(str(tmp_path))


def test_weights_keys_agree_across_packages(tmp_path):
    save_params(_port_model(_jax_tree()), TINY, str(tmp_path))
    for name in ("tiny-test", "llama3-8b"):
        for path in (None, str(tmp_path)):
            mine = TorchWorker._weights_key(types.SimpleNamespace(
                model_config=get_config(name), model_path=path))
            theirs = TpuWorker._weights_key(types.SimpleNamespace(
                model_config=ref_get_config(name), model_path=path))
            assert mine == theirs


# -- manifests, chunks and the budget (tolerance: bit-equal) -------------------

@pytest.mark.parametrize("chunk_bytes", [4096, striped.STRIPE_CHUNK_BYTES])
def test_manifest_wire_equals_the_reference(chunk_bytes):
    tree = _jax_tree()
    ref = ref_striped.WeightManifest.build(
        ref_client.flatten_params(tree), "tiny:k", chunk_bytes=chunk_bytes)
    mine = striped.WeightManifest.build(
        client.flatten_params(_port_model(tree)), "tiny:k",
        chunk_bytes=chunk_bytes)
    assert mine.to_wire() == ref.to_wire()
    assert any(p["dtype"] == "bfloat16" for p in mine.params)
    back = striped.WeightManifest.from_wire(json.loads(json.dumps(
        mine.to_wire())))
    assert back.to_wire() == mine.to_wire()


def test_corrupt_chunk_is_rejected_and_never_placed():
    flat = client.flatten_params(_port_model(_jax_tree()))
    m = striped.WeightManifest.build(flat, "tiny:c", chunk_bytes=2048)
    bufs = [to_bytes(t) for _, t in flat]
    good = {f["cid"]: f["data"] for f in striped.encode_chunk_frames(
        m, bufs, range(len(m.chunks)))}
    asm = striped.StripedAssembler(m)
    evil = b"\x00" * m.chunks[0].size
    assert striped.chunk_digest(evil) != m.chunks[0].digest
    assert asm.add(0, evil) is False and 0 in asm.missing
    assert asm.add(0, good[0][:-1]) is False  # size mismatch
    assert asm.add(len(m.chunks), good[0]) is False  # unknown cid
    assert asm.add_many(list(good.items())) == [True] * len(good)
    assert asm.add(0, good[0]) is True  # a repeat is placed once
    assert asm.complete
    for path, t in flat:
        assert _bits(asm.params()[path]) == _bits(t)
    frames = list(striped.encode_chunk_frames(m, bufs, [0, 10**6]))
    assert frames[0]["cid"] == 0 and "unknown chunk id" in frames[-1]["error"]


def test_bandwidth_budget_equals_the_reference():
    for frac in (-1.0, 0.0, 0.01, 0.1, 0.25, 0.5, 0.99, 1.0, 7.0):
        mine, ref = striped.BandwidthBudget(frac), ref_striped.BandwidthBudget(
            frac)
        assert mine.frac == ref.frac
        for cost in (-1.0, 0.0, 1e-4, 0.1, 2.5):
            assert mine.defer_after(cost) == ref.defer_after(cost)
        assert mine.deferred_total == ref.deferred_total


# -- the striped pull's control loop on stub donors ----------------------------

def _stub_donors(pkg, manifest, bufs, corrupt=None, dies_after=None):
    corrupt = corrupt or {}
    dies_after = dies_after or {}

    async def fetch_chunks(donor, cids):
        served = 0
        for frame in pkg.encode_chunk_frames(manifest, bufs, cids):
            if donor in dies_after and served >= dies_after[donor]:
                raise ConnectionError(f"{donor} evicted")
            served += 1
            data = frame["data"]
            if frame["cid"] in corrupt.get(donor, ()):
                data = b"\xff" * len(data)
            yield frame["cid"], data

    return fetch_chunks


@pytest.mark.parametrize("case", [
    dict(donors=["dying", "live"], dies_after={"dying": 1}),
    dict(donors=["a", "b", "c"], dies_after={"a": 0, "c": 2}),
    dict(donors=["bad", "good"], corrupt={"bad": {0, 1, 2}}),
    dict(donors=["d0", "d1"], dies_after={"d0": 0, "d1": 1}),
])
def test_striped_pull_restripes_as_the_reference(run, case):
    tree = _jax_tree()
    flat_ref = ref_client.flatten_params(tree)
    flat = client.flatten_params(_port_model(tree))
    m_ref = ref_striped.WeightManifest.build(flat_ref, "k:p", chunk_bytes=512)
    m = striped.WeightManifest.build(flat, "k:p", chunk_bytes=512)
    kw = {k: case[k] for k in ("corrupt", "dies_after") if k in case}
    ref_out = run(ref_striped.pull_striped(
        m_ref, case["donors"], _stub_donors(
            ref_striped, m_ref, [np.ascontiguousarray(a).tobytes()
                                 for _, a in flat_ref], **kw)))
    mine = run(striped.pull_striped(
        m, case["donors"], _stub_donors(
            striped, m, [to_bytes(t) for _, t in flat], **kw)))
    assert (mine is None) == (ref_out is None)
    if mine is not None:
        _assert_tree_equal(mine, tree)


# -- the weight service across packages (tolerance: bit-equal) -----------------

def test_weight_service_across_packages_both_ways(tmp_path):
    tree = _jax_tree()
    model = _port_model(tree)
    for server_pkg in ("port", "ref"):
        sock = str(tmp_path / f"{server_pkg}.sock")
        server = (serve_in_process(sock) if server_pkg == "port"
                  else ref_service.serve_in_process(sock))
        try:
            # the reference stores, the port fetches
            ref_client.WeightClient(sock).store("tiny:a", tree)
            got = client.WeightClient(sock).fetch("tiny:a")
            _assert_tree_equal(got, tree)
            # the port stores, the reference fetches
            client.WeightClient(sock).store("tiny:b", model)
            theirs = ref_client.WeightClient(sock).fetch("tiny:b")
            want = dict(ref_client.flatten_params(tree))
            assert sorted(theirs) == sorted(want)
            for path, arr in want.items():
                assert theirs[path].dtype == arr.dtype
                assert theirs[path].tobytes() == arr.tobytes(), path
            # the template check: a template of the wrong shape raises
            mine = client.WeightClient(sock)
            assert mine.fetch("absent") is None
            rebuilt = client.unflatten_like(
                _port_model(tree), mine.fetch("tiny:b"))
            _assert_tree_equal(dict(client.flatten_params(rebuilt)), tree)
            wide = dataclasses.replace(TINY, mlp_hidden=256)
            with pytest.raises(KeyError, match="model expects"):
                client.unflatten_like(
                    _port_model(_jax_tree(wide), wide), got)
            assert {m["model"] for m in mine.list()} == {"tiny:a", "tiny:b"}
        finally:
            server.stop()


def test_load_or_init_attaches_then_reuses(tmp_path):
    sock = str(tmp_path / "w.sock")
    server = serve_in_process(sock)
    tree = _jax_tree()
    calls = []

    def init():
        calls.append(1)
        return _port_model(tree)

    try:
        c = client.WeightClient(sock)
        assert c.ping()
        first, hit = c.load_or_init("tiny:l", _port_model(tree), init)
        second, hit2 = c.load_or_init("tiny:l", _port_model(tree), init)
        assert (hit, hit2, len(calls)) == (False, True, 1)
        _assert_tree_equal(dict(client.flatten_params(second)), tree)
    finally:
        server.stop()


# -- the object store across packages (tolerance: bit-equal) -------------------

def test_object_store_across_packages_both_ways(tmp_path):
    tree = _jax_tree()
    flat = client.flatten_params(_port_model(tree))
    store = objstore.make_store_client(str(tmp_path))
    ref_store = ref_objstore.make_store_client(str(tmp_path))
    assert objstore.weights_prefix("tiny:o") == ref_objstore.weights_prefix(
        "tiny:o")
    assert objstore.publish_weights_to_store(store, "tiny:o", flat) == (
        ref_objstore.publish_weights_to_store(
            ref_store, "tiny:r", ref_client.flatten_params(tree)))
    theirs = ref_objstore.fetch_weights_from_store(ref_store, "tiny:o")
    for path, arr in ref_client.flatten_params(tree):
        assert theirs[path].tobytes() == arr.tobytes(), path
    _assert_tree_equal(objstore.fetch_weights_from_store(store, "tiny:r"),
                       tree)
    # the same bytes under both keys' prefixes: the manifests agree
    for key in ("tiny:o", "tiny:r"):
        raw = json.loads((tmp_path / objstore.weights_prefix(key)
                          / "manifest.json").read_text())
        assert raw["weights_key"] == key
    assert objstore.fetch_weights_from_store(store, "tiny:none") is None
    victim = sorted((tmp_path / objstore.weights_prefix("tiny:o")
                     / "chunks").iterdir())[0]
    victim.write_bytes(b"\x00" * victim.stat().st_size)
    assert objstore.fetch_weights_from_store(store, "tiny:o") is None
    assert ref_objstore.fetch_weights_from_store(ref_store, "tiny:o") is None


# -- arrivals over the request plane -------------------------------------------

def _port_config(root) -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="file", discovery_path=str(root),
                         tcp_host="127.0.0.1", lease_ttl_secs=10.0,
                         system_enabled=False)


def _ref_config(root) -> RefRuntimeConfig:
    return RefRuntimeConfig.from_env(
        discovery_backend="file", discovery_path=str(root),
        request_plane="tcp", tcp_host="127.0.0.1", event_plane="mem",
        system_enabled=False)


def _greedy_body(rid: str) -> dict:
    return PreprocessedRequest(
        request_id=rid, token_ids=list(range(3, 20)),
        sampling=SamplingOptions(max_tokens=6, temperature=0.0),
        stop=StopConditions(ignore_eos=True)).to_wire()


async def _stream(worker, rid: str) -> list:
    return [t async for f in worker.generate(_greedy_body(rid))
            for t in f.get("t") or []]


def test_port_arrival_pulls_from_a_port_donor(run, tmp_path, monkeypatch):
    """Striped from two port donors, then (striping off) one peer: each
    arrival's leaves are bit-equal to the donors' and its greedy stream
    equals theirs."""
    tree = _jax_tree(CFG)
    component = f"w{uuid.uuid4().hex[:8]}"

    async def go():
        rt = await DistributedRuntime(_port_config(tmp_path)).start()
        donors, out = [], {}
        try:
            for _ in range(2):
                d = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                                params=_port_model(tree, CFG),
                                component=component)
                d.start()
                await d.serve(rt)
                donors.append(d)
            want = await _stream(donors[0], "donor-0")
            for stripe in ("1", "0"):
                monkeypatch.setenv("DYNT_WEIGHT_STRIPE", stripe)
                a = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                                component=component, weights_from_peer=True)
                assert a.runner is None
                await a.prepare(rt)
                out[stripe] = (a.weights_source,
                               dict(client.flatten_params(a.runner.model)),
                               await _stream(a, f"arrival-{stripe}"),
                               a.coldstart.report())
                a.close()
            served = donors[0]._donor_cache is not None or donors[
                1]._donor_cache is not None
        finally:
            for d in donors:
                await d.shutdown()
            await rt.shutdown()
        return want, out, served

    want, out, served = run(go(), timeout=40.0)
    assert served
    for stripe, source in (("1", "peer_striped"), ("0", "peer")):
        got_source, leaves, stream, report = out[stripe]
        assert got_source == source and report["source"] == source
        _assert_tree_equal(leaves, tree, CFG)
        assert stream == want and len(want) == 6
        assert report["total_secs"] is not None
        assert all(report["phases"][p] is not None for p in (
            "fetch", "load", "compile", "first_token"))


def test_port_arrival_pulls_striped_from_a_jax_donor(run, tmp_path):
    tree = _jax_tree(CFG)
    component = f"w{uuid.uuid4().hex[:8]}"

    async def go():
        ref_rt = await RefRuntime(_ref_config(tmp_path)).start()
        rt = await DistributedRuntime(_port_config(tmp_path)).start()
        donor = TpuWorker(ref_rt, model_name="tiny-test", component=component,
                          runner_config=JRunnerConfig(**RUNNER), warmup=False)
        donor.model_config = CFG

        async def shared():
            return tree, None

        donor._resolve_params = shared
        await donor.start()
        arrival = None
        try:
            want = [t async for f in donor.generate(_greedy_body("jax"))
                    for t in f.get("t") or []]
            arrival = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                                  component=component,
                                  weights_from_peer=True)
            assert arrival._weights_key() == donor._weights_key()
            await arrival.prepare(rt)
            got = await _stream(arrival, "arrival")
            return (arrival.weights_source, want, got,
                    dict(client.flatten_params(arrival.runner.model)))
        finally:
            if arrival is not None:
                arrival.close()
            await donor.close()
            await rt.shutdown()
            await ref_rt.shutdown()

    source, want, got, leaves = run(go(), timeout=40.0)
    assert source == "peer_striped"
    _assert_tree_equal(leaves, tree, CFG)
    assert got == want and len(want) == 6


def test_arrival_falls_down_the_ladder(run, tmp_path, monkeypatch):
    """A service that misses, no peer, then the object store a donor
    published to, then (the store emptied) the checkpoint; each arrival
    publishes forward to the service, which the next one attaches."""
    tree = _jax_tree(CFG)
    sock = str(tmp_path / "svc.sock")
    server = serve_in_process(sock)
    store_root = tmp_path / "store"
    ckpt = tmp_path / "ckpt"
    save_params(_port_model(tree, CFG), CFG, str(ckpt))
    monkeypatch.setenv("DYNT_WEIGHT_STORE", str(store_root))

    async def go():
        sources = []
        donor = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                            params=_port_model(tree, CFG))
        key = donor._weights_key()
        objstore.publish_weights_to_store(
            objstore.make_store_client(str(store_root)), key,
            client.flatten_params(donor.runner.model))
        donor.close()
        for _ in range(2):
            a = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                            weight_service=sock)
            await a.prepare()
            await a._publish_task
            sources.append((a.weights_source,
                            dict(client.flatten_params(a.runner.model))))
            a.close()
        # a checkpoint worker: the store holds another key (its digest)
        c = TorchWorker(model_path=str(ckpt), dtype="float32", device="cpu",
                        runner_config=RunnerConfig(**RUNNER))
        await c.prepare()
        await c._publish_task
        sources.append((c.weights_source, None))
        c.close()
        return sources

    try:
        sources = run(go(), timeout=40.0)
    finally:
        server.stop()
    assert [s for s, _ in sources] == ["object_store", "service",
                                       "checkpoint"]
    for _, leaves in sources[:2]:
        _assert_tree_equal(leaves, tree, CFG)


def test_moe_trees_cross_one_way(tmp_path):
    """A MoE layer of the port holds no dense MLP leaves; the reference's
    holds three unused ones. A JAX-published MoE arena loads into the
    port (the extra leaves are left behind); a port-published one misses
    the reference's template (KeyError), so its arrival takes the next
    rung."""
    cfg = get_config("tiny-moe-test")
    tree = _jax_tree(ref_get_config("tiny-moe-test"))
    sock = str(tmp_path / "moe.sock")
    server = serve_in_process(sock)
    try:
        ref_client.WeightClient(sock).store("moe:j", tree)
        got = client.WeightClient(sock).fetch("moe:j")
        model = client.unflatten_like(_port_model(tree, cfg), got)
        _assert_tree_equal(dict(client.flatten_params(model)), tree, cfg)
        assert any(k.endswith("/w_gate") for k in got)
        client.WeightClient(sock).store("moe:p", model)
        theirs = ref_client.WeightClient(sock).fetch("moe:p")
        with pytest.raises(KeyError, match="w_down"):
            ref_client.unflatten_like(tree, theirs)
    finally:
        server.stop()
