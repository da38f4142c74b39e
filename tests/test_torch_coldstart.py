"""The port's arrival ladder against the JAX package's: the cold-start
ladder, the compile-cache sync and the snapshot gate.

  * `ColdStartLadder` under one patched clock: the reports, totals and the
    process-wide EWMA equal the reference's (accounting, idempotent
    `first_token`, late marks ignored), and both warn past
    DYNT_COLDSTART_BUDGET_SECS;
  * with DYNT_CONFORMANCE=1 a ladder and striped pulls (a clean one, one
    whose donor dies, one that gives up) record no violation of the
    `coldstart` and `striped_weight_pull` specs;
  * `sync_up` / `sync_down` round-trip the kernel build directory through a
    filesystem store, byte-equal, and interoperate with the reference's
    index; traversal names are skipped; no store knob, no work;
  * `SnapshotController`'s modes and markers equal the reference's; the
    worker CLI under DYNT_SNAPSHOT_MODE=dump prepares with no runtime,
    writes the ready marker, waits for the restore marker, and serves with
    a new instance id.

CPU only, tiny-test, no process spawned, 127.0.0.1 only.
"""

import asyncio
import logging
import os
import types

import pytest

from dynamo_tpu.engine import coldstart as ref_coldstart
from dynamo_tpu.engine import compile_cache as ref_compile_cache
from dynamo_tpu.runtime import snapshot as ref_snapshot
from dynamo_tpu_torch.engine import coldstart, compile_cache
from dynamo_tpu_torch.engine.worker import TorchWorker
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.runtime import conformance, snapshot
from dynamo_tpu_torch.runtime.discovery import FileDiscovery
from dynamo_tpu_torch.weights import striped
from dynamo_tpu_torch.weights.objstore import make_store_client


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    clk = _Clock()
    fake = types.SimpleNamespace(monotonic=clk.monotonic)
    for mod in (coldstart, ref_coldstart):
        monkeypatch.setattr(mod, "time", fake)
        mod.reset_observations()
    yield clk
    for mod in (coldstart, ref_coldstart):
        mod.reset_observations()


# Each script: ("mark", phase, secs) | ("phase", phase, secs) |
# ("wait", secs) | ("first",) — run on both ladders in lockstep
SCRIPTS = [
    [("phase", "fetch", 2.5), ("phase", "load", 1.25), ("mark", "compile",
                                                        0.5),
     ("phase", "compile", 3.0), ("phase", "register", 0.125), ("wait", 4.0),
     ("first",), ("mark", "compile", 9.0), ("first",)],
    [("first",), ("mark", "fetch", 1.0), ("first",)],
    [("mark", "fetch", 0.0), ("wait", 0.5), ("phase", "load", 0.0),
     ("wait", 70.0), ("first",)],
]


def _play(ladder, clock, script) -> list:
    totals = []
    for step in script:
        if step[0] == "mark":
            ladder.mark(step[1], step[2])
        elif step[0] == "phase":
            with ladder.phase(step[1]):
                clock.t += step[2]
        elif step[0] == "wait":
            clock.t += step[1]
        else:
            totals.append(ladder.first_token())
    return totals


@pytest.mark.parametrize("script", range(len(SCRIPTS)))
def test_ladder_reports_equal_the_reference(clock, script, caplog,
                                            monkeypatch):
    ref_warned = []
    monkeypatch.setattr(ref_coldstart.log, "warning",
                        lambda *args, **kw: ref_warned.append(args))
    start = clock.t
    mine = coldstart.ColdStartLadder("w", source="peer_striped")
    theirs = ref_coldstart.ColdStartLadder("w", source="peer_striped")
    with caplog.at_level(logging.WARNING):
        clock.t = start
        got = _play(mine, clock, SCRIPTS[script])
        clock.t = start
        want = _play(theirs, clock, SCRIPTS[script])
    assert got == want and got[0] is not None
    assert mine.report() == theirs.report()
    assert all(t == got[0] for t in got)  # idempotent first_token
    assert coldstart.last_cold_start_secs() == (
        ref_coldstart.last_cold_start_secs())
    over = [r for r in caplog.records
            if "exceeded the pinned budget" in r.getMessage()]
    assert len(over) == len(ref_warned) == (1 if got[0] > 60.0 else 0)


def test_ewma_equals_the_reference(clock):
    assert coldstart.observed_cold_start_secs() is None
    for total in (10.0, 4.0, 31.5, 0.25):
        for mod in (coldstart, ref_coldstart):
            lad = mod.ColdStartLadder("e")
            clock.t += total
            lad.first_token()
            clock.t -= total
        assert coldstart.observed_cold_start_secs() == pytest.approx(
            ref_coldstart.observed_cold_start_secs(), rel=0, abs=0)
    assert coldstart.last_cold_start_secs() == 0.25


@pytest.fixture
def monitor(monkeypatch):
    monkeypatch.setenv("DYNT_CONFORMANCE", "1")
    conformance.reset_monitor()
    yield conformance.get_monitor()
    conformance.reset_monitor()


def _stub_fetch(manifest, bufs, dies_after=None):
    dies_after = dies_after or {}

    async def fetch_chunks(donor, cids):
        for n, frame in enumerate(striped.encode_chunk_frames(
                manifest, bufs, cids)):
            if donor in dies_after and n >= dies_after[donor]:
                raise ConnectionError(f"{donor} evicted")
            yield frame["cid"], frame["data"]

    return fetch_chunks


def test_lifecycles_record_no_violation(run, monitor, clock):
    lad = coldstart.ColdStartLadder("c")
    for phase in ("fetch", "load", "compile", "compile", "register"):
        lad.mark(phase, 0.5)
    lad.first_token()
    lad.mark("compile", 1.0)  # late: ignored, not observed
    bufs = [bytes(range(256)) * 9, bytes(7)]
    flat = [("a", bufs[0]), ("b", bufs[1])]
    m = striped.WeightManifest.build_from_bytes(
        [(p, "uint8", [len(b)], memoryview(b)) for p, b in flat], "k",
        chunk_bytes=256)
    outcomes = [run(striped.pull_striped(m, donors, _stub_fetch(
        m, bufs, dies)))
        for donors, dies in ((["x", "y"], None), (["x", "y"], {"x": 1}),
                             (["x", "y"], {"x": 0, "y": 1}))]
    assert [o is not None for o in outcomes] == [True, True, False]
    snap = monitor.snapshot()
    assert {"coldstart", "striped_weight_pull"} <= set(
        snap["protocols_loaded"])
    assert snap["total_violations"] == 0, snap["violations"]


# -- the compile cache ---------------------------------------------------------

def _write(root, files: dict) -> None:
    for name, data in files.items():
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


def _read(root) -> dict:
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_compile_cache_round_trips_with_the_reference(tmp_path, monkeypatch):
    libs = {"paged_decode_pool-0123456789abcdef.so": os.urandom(3000),
            "q8_matmul-fedcba9876543210.so": os.urandom(1000),
            "q8_matmul-fedcba9876543210.log": b"ptxas info",
            "nested/x.so": b"n"}
    partial = {"q4_matmul-0000000000000000.123.tmp.so": b"partial",
               "junk.tmp": b"t", "build.lock": b""}
    src = tmp_path / "src"
    _write(src, {**libs, **partial})
    store_root = str(tmp_path / "store")
    # unset, the cache is the kernel build directory
    monkeypatch.delenv("DYNT_COMPILE_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == str(_build.BUILD_DIR)
    # no store knob: no work
    monkeypatch.delenv("DYNT_COMPILE_CACHE_STORE", raising=False)
    monkeypatch.setenv("DYNT_COMPILE_CACHE_DIR", str(src))
    assert compile_cache.cache_dir() == str(src)
    assert compile_cache.sync_up() == 0 and compile_cache.sync_down() == 0
    monkeypatch.setenv("DYNT_COMPILE_CACHE_STORE", store_root)
    assert compile_cache.sync_up() == len(libs)
    assert compile_cache.sync_up() == 0  # already indexed
    for mod, name in ((compile_cache, "port"), (ref_compile_cache, "ref")):
        dest = tmp_path / name
        monkeypatch.setenv("DYNT_COMPILE_CACHE_DIR", str(dest))
        assert mod.sync_down() == len(libs)
        assert _read(dest) == libs  # byte-equal, no partial file
        assert mod.sync_down() == 0
    # the reference publishes, the port pulls; traversal names are skipped
    store = make_store_client(store_root)
    ref_src = tmp_path / "ref_src"
    _write(ref_src, {"extra-1111111111111111.so": b"e"})
    monkeypatch.setenv("DYNT_COMPILE_CACHE_DIR", str(ref_src))
    assert ref_compile_cache.sync_up() == 1
    index = store.get_bytes("compile-cache/index.json")
    store.put_bytes("compile-cache/index.json", index.replace(
        b'"entries": [', b'"entries": ["../evil.so", "/abs.so", '))
    monkeypatch.setenv("DYNT_COMPILE_CACHE_DIR", str(tmp_path / "port"))
    assert compile_cache.sync_down() == 1
    assert _read(tmp_path / "port") == {**libs,
                                        "extra-1111111111111111.so": b"e"}
    assert not (tmp_path / "evil.so").exists()


# -- the snapshot gate ---------------------------------------------------------

def test_snapshot_controller_equals_the_reference(run, tmp_path):
    for mod in (snapshot, ref_snapshot):
        with pytest.raises(ValueError):
            mod.SnapshotController(mode="bogus")
    pairs = [(snapshot.SnapshotController(mode=mode, directory=str(
        tmp_path / f"p-{mode}")), ref_snapshot.SnapshotController(
        mode=mode, directory=str(tmp_path / f"r-{mode}")))
        for mode in ("off", "dump")]
    for mine, theirs in pairs:
        assert mine.enabled == theirs.enabled
        assert (os.path.basename(mine.ready_path),
                os.path.basename(mine.restore_path)) == (
            os.path.basename(theirs.ready_path),
            os.path.basename(theirs.restore_path))
    ctl = pairs[1][0]
    ctl.engine_ready()
    assert open(ctl.ready_path).read() == str(os.getpid())

    async def gated():
        waiter = asyncio.create_task(ctl.wait_for_restore(poll=0.01))
        await asyncio.sleep(0.05)
        assert not waiter.done()  # gated until the marker appears
        with open(ctl.restore_path, "w") as f:
            f.write("go")
        await asyncio.wait_for(waiter, 5)

    run(gated(), timeout=30)
    ctl.engine_ready()  # a fresh ready signal clears a stale restore marker
    assert not os.path.exists(ctl.restore_path)
    ctl.clear()
    assert not os.path.exists(ctl.ready_path)


def test_snapshot_gated_worker_serves_with_a_new_identity(run, tmp_path,
                                                           monkeypatch):
    from dynamo_tpu_torch.engine.worker import main as worker_main
    from dynamo_tpu_torch.runtime.signals import request_shutdown

    snap = tmp_path / "snap"
    for key, val in {"DYNT_DISCOVERY_PATH": str(tmp_path / "disc"),
                     "DYNT_DISCOVERY_BACKEND": "file",
                     "DYNT_TCP_HOST": "127.0.0.1",
                     "DYNT_SYSTEM_ENABLED": "0",
                     "DYNT_SNAPSHOT_MODE": "dump",
                     "DYNT_SNAPSHOT_DIR": str(snap)}.items():
        monkeypatch.setenv(key, val)
    ids = []
    rederive = TorchWorker.rederive_identity

    def recording(self):
        before = self.instance_id
        rederive(self)
        ids.append((before, self.instance_id, self.events.worker_id))

    monkeypatch.setattr(TorchWorker, "rederive_identity", recording)

    async def go():
        disc = FileDiscovery(str(tmp_path / "disc"))
        worker = asyncio.ensure_future(worker_main([
            "--model", "tiny-test", "--device", "cpu", "--page-size", "4",
            "--num-pages", "64", "--max-batch", "2",
            "--max-pages-per-seq", "16"]))
        try:
            while not (snap / "ready").exists():
                assert not worker.done(), worker.exception()
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.3)
            before = await disc.get_prefix("v1/")  # nothing at the dump
            (snap / "restore").write_text("go")
            cards = {}
            while not cards:
                assert not worker.done(), worker.exception()
                cards = await disc.get_prefix("v1/mdc/")
                await asyncio.sleep(0.05)
        finally:
            request_shutdown("test")
            await asyncio.wait_for(worker, 30)
        return before, cards

    before, cards = run(go(), timeout=60.0)
    assert before == {}
    ((old, new, events_id),) = ids
    assert new != old and events_id == new
    (key,) = cards
    assert key.rsplit("/", 1)[1] == str(new)
