"""The port's KV block manager (`dynamo_tpu_torch/block_manager/`) against
the JAX package's `dynamo_tpu/block_manager/`, at tiny sizes on the CPU.

The same seeded inputs (numpy, bf16 as its uint16 bit patterns) go through
both packages, and the same calls must give the same results (tolerance 0:
bytes, hashes, counters): the block state machine; TierPool's dedup, LRU
cascade, pins, TinyLFU admission and match_prefix over seeded operation
sequences; BlockLayoutSpec's geometry and wire dicts (bf16, f32, packed
int8), from both runners' `kv_layout()`; `reslice` / `assemble`;
`sign_request` and `verify_signature` across the packages; ObjectStore's
retries, partial reads and wrong shapes over a fake client and the HTTP
client against a stdlib S3-shaped stub on 127.0.0.1; the OffloadManager's
exactly-once `dropped` ledger; the manager's cascade, promotion, pin leases
and park store. One difference is pinned: the port reads back a bf16 G4
blob (its own and the reference's), where the reference's `get` misses and
deletes it.
"""

import dataclasses
import http.server
import io
import queue as thread_queue
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import block_manager as ref
from dynamo_tpu.block_manager import storage as ref_storage
from dynamo_tpu.block_manager.state import BlockState as RefBlockState
from dynamo_tpu_torch import block_manager as port
from dynamo_tpu_torch.block_manager import storage as port_storage
from dynamo_tpu_torch.block_manager.state import BlockState

F32 = dict(n_layers=2, total_kv_heads=4, head_dim=8, page_size=4,
           dtype="float32")
BF16 = dict(F32, dtype="bfloat16")
INT8 = dict(n_layers=2, total_kv_heads=4, head_dim=8, page_size=4,
            dtype="bfloat16", kv_dtype="int8", scale_lanes=128)
SPECS = {"float32": F32, "bfloat16": BF16, "int8": INT8}


def _specs(kind: str, **extra):
    kw = dict(SPECS[kind], **extra)
    return ref.BlockLayoutSpec(**kw), port.BlockLayoutSpec(**kw)


def _words(spec, seed: int, n=None) -> np.ndarray:
    """Seeded storage words of n blocks (or one): f32 values, bf16 bit
    patterns as uint16, packed int8 bytes with one scale per token."""
    rng = np.random.default_rng(seed)
    shape = spec.block_shape if n is None else (n,) + spec.block_shape
    if spec.kv_dtype == "int8":
        lead = () if n is None else (n,)
        nv = (spec.n_layers * spec.kv_dims * spec.page_size
              * spec.kv_head_count * spec.head_dim)
        values = rng.integers(0, 256, lead + (nv,)).astype(np.uint8)
        tok = np.asarray(rng.uniform(0.01, 2.0, lead + (
            spec.n_layers * spec.kv_dims * spec.page_size,)),
            ml_dtypes.bfloat16).view(np.uint16)
        scales = np.repeat(tok[..., None], spec.scale_lanes, axis=-1)
        return np.concatenate(
            [values, scales.reshape(lead + (-1,)).view(np.uint8)], axis=-1)
    x = rng.standard_normal(shape).astype(np.float32)
    if spec.dtype == "bfloat16":
        return np.asarray(x, ml_dtypes.bfloat16).view(np.uint16)
    return x


def _as_ref(words: np.ndarray, spec) -> np.ndarray:
    return words.view(ml_dtypes.bfloat16) if spec.dtype == "bfloat16" \
        else words


def _as_port(words: np.ndarray, spec) -> torch.Tensor:
    words = np.ascontiguousarray(words)
    if spec.dtype == "bfloat16":
        return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(words.copy())


def _bits_ref(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _bits_port(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# -- the state machine ------------------------------------------------------


@pytest.mark.parametrize("seq", [
    ("init_sequence", "commit", "register", "reset"),
    ("commit",), ("register",), ("init_sequence", "register"),
    ("init_sequence", "reset", "init_sequence", "commit", "reset"),
    ("init_sequence", "commit", "commit"), ("reset",),
    ("init_sequence", "commit", "register", "init_sequence"),
], ids=lambda s: "-".join(x[:4] for x in s))
def test_state_transitions_match_reference(seq):
    mine, theirs = port.BlockHandle(3), ref.BlockHandle(3)
    for step in seq:
        outcome = []
        for handle, err in ((mine, port.BlockStateError),
                            (theirs, ref.BlockStateError)):
            args = (11, 7) if step == "commit" else ()
            try:
                getattr(handle, step)(*args)
                outcome.append("ok")
            except err as exc:
                outcome.append(str(exc))
        assert outcome[0] == outcome[1], step
        assert mine.state.value == theirs.state.value
        assert (mine.sequence_hash, mine.parent_hash) == (
            theirs.sequence_hash, theirs.parent_hash)
    assert [s.value for s in BlockState] == [s.value for s in RefBlockState]


# -- TierPool ----------------------------------------------------------------


def _pool_ops(seed: int, n: int = 160):
    rng = np.random.default_rng(seed)
    kinds = ["insert"] * 6 + ["get"] * 4 + ["pin", "unpin", "remove",
                                            "match"]
    for _ in range(n):
        kind = kinds[rng.integers(len(kinds))]
        h = int(rng.integers(1, 12))
        if kind == "match":
            yield kind, [int(x) for x in rng.integers(1, 12, 4)]
        else:
            yield kind, h


@pytest.mark.parametrize("admission", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tier_pool_matches_reference(seed, admission):
    rspec, pspec = _specs("bfloat16")
    evicted = {"ref": [], "port": []}
    rpool = ref.TierPool("g2", ref.HostArena(rspec, 4), admission=admission,
                         on_evict=lambda h, d: evicted["ref"].append(
                             (h, _bits_ref(d).tobytes())))
    ppool = port.TierPool("g2", port.HostArena(pspec, 4),
                          admission=admission,
                          on_evict=lambda h, d: evicted["port"].append(
                              (h, _bits_port(d).tobytes())))
    for kind, arg in _pool_ops(seed):
        if kind == "insert":
            w = _words(rspec, arg)
            got = (rpool.insert(arg, _as_ref(w, rspec)),
                   ppool.insert(arg, _as_port(w, pspec)))
        elif kind == "get":
            r, p = rpool.get(arg), ppool.get(arg)
            got = ((None if r is None else _bits_ref(r).tobytes()),
                   (None if p is None else _bits_port(p).tobytes()))
        elif kind == "pin":
            got = rpool.pin(arg), ppool.pin(arg)
        elif kind == "unpin":
            got = rpool.unpin(arg), ppool.unpin(arg)
        elif kind == "remove":
            got = rpool.remove(arg), ppool.remove(arg)
        else:
            got = rpool.match_prefix(arg), ppool.match_prefix(arg)
        assert got[0] == got[1], (kind, arg)
        assert len(rpool) == len(ppool)
    assert evicted["ref"] == evicted["port"]
    assert dataclasses.asdict(rpool.stats) == dataclasses.asdict(ppool.stats)
    assert rpool.usage() == ppool.usage()
    assert rpool.clear() == ppool.clear()


# -- layout ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_layout_geometry_and_wire(kind):
    r, p = _specs(kind, kv_head_start=1, kv_head_count=2)
    assert p.block_shape == r.block_shape
    assert p.block_bytes() == r.block_bytes()
    assert p.to_wire() == r.to_wire()
    assert port.BlockLayoutSpec.from_wire(r.to_wire()) == p
    assert ref.BlockLayoutSpec.from_wire(p.to_wire()) == r
    assert p.head_range() == r.head_range() == (1, 3)
    assert p.quantized == r.quantized == (kind == "int8")


def test_layout_refuses_what_the_reference_refuses():
    for kw in (dict(F32, kv_head_start=3, kv_head_count=2),
               dict(INT8, scale_lanes=0)):
        with pytest.raises(ValueError):
            ref.BlockLayoutSpec(**kw)
        with pytest.raises(ValueError):
            port.BlockLayoutSpec(**kw)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_from_runner_layout_of_both_runners(kv_dtype):
    from dynamo_tpu.engine import ModelRunner as JRunner
    from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
    from dynamo_tpu.models import get_config
    from dynamo_tpu.parallel import MeshConfig, make_mesh
    from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig

    cfg = dataclasses.replace(get_config("tiny-test"), head_dim=128)
    rc = dict(page_size=4, num_pages=8, max_batch=1, max_pages_per_seq=4,
              prefill_buckets=(8,), kv_dtype=kv_dtype)
    mine = ModelRunner(cfg, RunnerConfig(**rc), device="cpu").kv_layout()
    theirs = JRunner(cfg, JRunnerConfig(**rc), make_mesh(MeshConfig()),
                     seed=0).kv_layout()
    want = ref.BlockLayoutSpec.from_runner_layout(theirs)
    got = port.BlockLayoutSpec.from_runner_layout(mine)
    assert got.to_wire() == want.to_wire()
    assert got.block_shape == want.block_shape
    assert got.block_bytes() == want.block_bytes()


def _bundle(spec, seed, n=3):
    w = _words(spec, seed, n)
    return _as_ref(w, spec), _as_port(w, spec)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("heads", [(0, 2), (1, 2), (2, 1), (0, 4)])
def test_reslice_is_bit_exact(kind, heads):
    src_r, src_p = _specs(kind)
    dst_r, dst_p = _specs(kind, kv_head_start=heads[0],
                          kv_head_count=heads[1])
    b_r, b_p = _bundle(src_r, 5)
    want = ref.reslice(b_r, src_r, dst_r)
    got = port.reslice(b_p, src_p, dst_p)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(_bits_port(got), _bits_ref(want))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_assemble_is_bit_exact(kind):
    """Two TP=2 shards -> a TP=4 shard over heads [1, 3) and the whole."""
    full_r, full_p = _specs(kind)
    b_r, b_p = _bundle(full_r, 9)
    shards_r, shards_p = [], []
    for start in (0, 2):
        sr, sp = _specs(kind, kv_head_start=start, kv_head_count=2)
        shards_r.append((sr, ref.reslice(b_r, full_r, sr)))
        shards_p.append((sp, port.reslice(b_p, full_p, sp)))
    for heads in ((1, 2), (0, 4)):
        dr, dp = _specs(kind, kv_head_start=heads[0], kv_head_count=heads[1])
        want = ref.assemble(shards_r, dr)
        got = port.assemble(shards_p, dp)
        assert np.array_equal(_bits_port(got), _bits_ref(want))


def test_assemble_refusals_match_reference():
    full_r, full_p = _specs("int8")
    b_r, b_p = _bundle(full_r, 4)
    half_r, half_p = _specs("int8", kv_head_start=0, kv_head_count=2)
    rest_r, rest_p = _specs("int8", kv_head_start=2, kv_head_count=2)
    three_r, three_p = _specs("int8", kv_head_count=3)
    # uncovered heads
    with pytest.raises(ValueError, match="cover"):
        ref.assemble([(half_r, ref.reslice(b_r, full_r, half_r))], three_r)
    with pytest.raises(ValueError, match="cover"):
        port.assemble([(half_p, port.reslice(b_p, full_p, half_p))], three_p)
    # disagreeing scale rows
    bad_r = ref.reslice(b_r, full_r, rest_r).copy()
    bad_r[:, -1] ^= 1
    with pytest.raises(ValueError, match="disagreeing"):
        ref.assemble([(half_r, ref.reslice(b_r, full_r, half_r)),
                      (rest_r, bad_r)], full_r)
    with pytest.raises(ValueError, match="disagreeing"):
        port.assemble([(half_p, port.reslice(b_p, full_p, half_p)),
                       (rest_p, torch.from_numpy(bad_r.copy()))], full_p)
    # a packed and an unpacked layout never bridge
    f_r, f_p = _specs("bfloat16")
    with pytest.raises(ValueError, match="bridge"):
        ref.reslice(b_r, full_r, f_r)
    with pytest.raises(ValueError, match="bridge"):
        port.reslice(b_p, full_p, f_p)


# -- G4 request signing --------------------------------------------------------


@pytest.mark.parametrize("method,path,body", [
    ("PUT", "/bucket/ab/v2-abcdef0123456789.npy", b"\x93NUMPY" * 7),
    ("GET", "/ab/v2-00000000000000ab.npy", None),
    ("DELETE", "/k", b""),
])
def test_sign_request_is_byte_equal(method, path, body):
    date = "20261018T120000Z"
    want = ref_storage.sign_request(method, path, body, "kid", "s3cr3t",
                                    date=date)
    got = port_storage.sign_request(method, path, body, "kid", "s3cr3t",
                                    date=date)
    assert got == want
    now = 1_792_324_800.0  # 2026-10-18T12:00:00Z
    secrets = {"kid": "s3cr3t"}
    for verify in (ref_storage.verify_signature,
                   port_storage.verify_signature):
        assert verify(method, path, body, got, secrets, now=now) is None
        assert verify(method, path, body, got, {"kid": "x"},
                      now=now) == "bad-signature"
        assert verify(method, path, body, got, secrets,
                      now=now + 3600) == "expired"
        assert verify(method, path, body, {}, secrets, now=now) == "unsigned"
        assert verify(method, path, body, got, {}, now=now) == "unknown-key"


# -- the object store ----------------------------------------------------------


class FakeClient:
    """Injected faults: transient failures and truncated reads."""

    def __init__(self, error, fail_next=0, truncate_next=0):
        self.error = error
        self.blobs = {}
        self.fail_next = fail_next
        self.truncate_next = truncate_next

    def _maybe_fail(self):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise self.error("injected")

    def put_bytes(self, key, data):
        self._maybe_fail()
        self.blobs[key] = data

    def get_bytes(self, key):
        self._maybe_fail()
        data = self.blobs.get(key)
        if data is not None and self.truncate_next > 0:
            self.truncate_next -= 1
            return data[: len(data) // 3]
        return data

    def exists(self, key):
        self._maybe_fail()
        return key in self.blobs

    def delete(self, key):
        self._maybe_fail()
        self.blobs.pop(key, None)


def _stores(kind="float32", **faults):
    rspec, pspec = _specs(kind)
    rc = FakeClient(ref_storage.TransientStorageError, **faults)
    pc = FakeClient(port_storage.TransientStorageError, **faults)
    return (ref.ObjectStore(rspec, rc, backoff=0.0),
            port.ObjectStore(pspec, pc, backoff=0.0), rc, pc, rspec, pspec)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return ("raised", type(exc).__name__)


@pytest.mark.parametrize("faults", [
    dict(fail_next=2), dict(fail_next=4), dict(fail_next=9),
    dict(truncate_next=1)], ids=["retried", "exhausted-1", "exhausted",
                                 "partial"])
def test_object_store_faults_match_reference(faults):
    rs, ps, rc, pc, rspec, pspec = _stores(**faults)
    w = _words(rspec, 3)
    put = (_outcome(lambda: rs.put(0xAB, _as_ref(w, rspec))),
           _outcome(lambda: ps.put(0xAB, _as_port(w, pspec))))
    assert put[0] == put[1]
    r, p = rs.get(0xAB), ps.get(0xAB)
    assert (r is None) == (p is None)
    if r is not None:
        assert np.array_equal(_bits_port(p), _bits_ref(r))
    assert rs.contains(0xAB) == ps.contains(0xAB)
    assert (rs.retried_ops, rs.corrupt_reads) == (ps.retried_ops,
                                                  ps.corrupt_reads)
    assert sorted(rc.blobs) == sorted(pc.blobs)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_object_store_rejects_wrong_blobs_as_reference(bad):
    rs, ps, rc, pc, rspec, pspec = _stores()
    shape = (3,) if bad == "shape" else rspec.block_shape
    dtype = np.float64 if bad == "dtype" else np.float32
    buf = io.BytesIO()
    np.save(buf, np.zeros(shape, dtype))
    key = rs._key(0x77)
    assert key == ps._key(0x77)
    rc.blobs[key] = pc.blobs[key] = buf.getvalue()
    assert rs.get(0x77) is None and ps.get(0x77) is None
    assert rs.corrupt_reads == ps.corrupt_reads == 1
    assert not rc.blobs and not pc.blobs  # quarantined


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_object_blob_is_byte_equal(kind, tmp_path):
    """The same block under the same hash: the same key and the same
    `.npy` bytes (a bf16 header says '<V2', as ml_dtypes' np.save)."""
    rspec, pspec = _specs(kind)
    w = _words(rspec, 8)
    rs = ref.ObjectStore(rspec, str(tmp_path / "ref"))
    ps = port.ObjectStore(pspec, str(tmp_path / "port"))
    h = 0xFEEDFACE12345678
    rs.put(h, _as_ref(w, rspec))
    ps.put(h, _as_port(w, pspec))
    key = rs._key(h)
    assert ps._key(h) == key
    assert ((tmp_path / "port" / key).read_bytes()
            == (tmp_path / "ref" / key).read_bytes())


def test_bf16_object_blob_reads_back_where_the_reference_misses(tmp_path):
    """The reference's bf16 G4 round trip misses: np.load gives a V2
    array, its dtype check calls the blob corrupt and deletes it. The
    port reads back its own blob and the reference's."""
    rspec, pspec = _specs("bfloat16")
    w = _words(rspec, 12)
    rs = ref.ObjectStore(rspec, str(tmp_path / "g4"))
    ps = port.ObjectStore(pspec, str(tmp_path / "g4"))
    rs.put(7, _as_ref(w, rspec))
    got = ps.get(7)  # the reference's blob
    assert got is not None and got.dtype == torch.bfloat16
    assert np.array_equal(_bits_port(got), w)
    ps.put(8, _as_port(w, pspec))
    assert np.array_equal(_bits_port(ps.get(8)), w)  # its own
    assert ps.corrupt_reads == 0
    assert rs.get(7) is None and rs.corrupt_reads == 1
    assert not rs.contains(7)  # the reference deleted the blob


def test_gcs_url_refused_like_reference(tmp_path):
    rspec, pspec = _specs("float32")
    for store, spec in ((ref.ObjectStore, rspec), (port.ObjectStore, pspec)):
        with pytest.raises(NotImplementedError):
            store(spec, "gs://bucket/kv")


class _S3Stub:
    """An S3/GCS-REST-shaped server (PUT / GET / HEAD / DELETE on /{key})
    on 127.0.0.1, with injected 503s and truncated bodies."""

    def __init__(self):
        stub = self
        self.blobs, self.fail_next, self.truncate_next = {}, 0, 0

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, body=b"", length=None):
                self.send_response(code)
                self.send_header("Content-Length",
                                 str(len(body) if length is None else length))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass

            def _failed(self):
                if stub.fail_next > 0:
                    stub.fail_next -= 1
                    self._reply(503)
                    return True
                return False

            def do_PUT(self):
                if not self._failed():
                    n = int(self.headers.get("Content-Length", 0))
                    stub.blobs[self.path] = self.rfile.read(n)
                    self._reply(200)

            def do_GET(self):
                if self._failed():
                    return
                data = stub.blobs.get(self.path)
                if data is None:
                    self._reply(404)
                elif stub.truncate_next > 0:
                    stub.truncate_next -= 1
                    self._reply(200, data[:-64], length=len(data))
                else:
                    self._reply(200, data)

            def do_HEAD(self):
                if not self._failed():
                    self.send_response(200 if self.path in stub.blobs
                                       else 404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def do_DELETE(self):
                if not self._failed():
                    stub.blobs.pop(self.path, None)
                    self._reply(200)

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


@pytest.fixture()
def s3_stub():
    stub = _S3Stub()
    try:
        yield stub
    finally:
        stub.close()


def test_http_store_round_trip_and_faults(s3_stub, tmp_path):
    rspec, pspec = _specs("bfloat16")
    w = _words(rspec, 2)
    ps = port.ObjectStore(pspec, s3_stub.url, backoff=0.001)
    assert isinstance(ps.client, port_storage.HttpObjectStoreClient)
    ps.put(0x1234, _as_port(w, pspec))
    key = ps._key(0x1234)
    assert list(s3_stub.blobs) == ["/" + key]
    # the HTTP blob is the file the filesystem client writes
    fs = port.ObjectStore(pspec, str(tmp_path))
    fs.put(0x1234, _as_port(w, pspec))
    assert s3_stub.blobs["/" + key] == (tmp_path / key).read_bytes()
    assert ps.contains(0x1234) and not ps.contains(0x9999)
    assert np.array_equal(_bits_port(ps.get(0x1234)), w)
    s3_stub.fail_next = 2  # 503s: retried on put
    ps.put(0x55, _as_port(w, pspec))
    assert ps.retried_ops == 2
    s3_stub.fail_next = 1  # a read takes one attempt: a miss
    assert ps.get(0x55) is None
    s3_stub.truncate_next = 1  # Content-Length > body: a partial read
    assert ps.get(0x55) is None
    assert ps.get(0x55) is not None  # a transient miss, not a deletion
    ps.delete(0x55)
    assert not ps.contains(0x55)


def test_http_store_server_down_is_a_miss():
    rspec, pspec = _specs("float32")
    srv = _S3Stub()
    url = srv.url
    srv.close()
    for store, spec, w in (
            (ref.ObjectStore(rspec, url, backoff=0.0, retries=1), rspec,
             _as_ref(_words(rspec, 1), rspec)),
            (port.ObjectStore(pspec, url, backoff=0.0, retries=1), pspec,
             _as_port(_words(rspec, 1), pspec))):
        assert store.get(1) is None and not store.contains(1)
        with pytest.raises(Exception) as exc:
            store.put(1, w)
        assert type(exc.value).__name__ == "TransientStorageError"


def test_http_store_signs_for_the_reference_verifier(s3_stub):
    """An hmac-signed client's requests verify with either package's
    verify_signature; a bearer client sends its token."""
    seen = []
    handler = s3_stub._srv.RequestHandlerClass
    orig = handler.do_PUT

    def do_put(self):
        seen.append((self.path, dict(self.headers)))
        orig(self)

    handler.do_PUT = do_put
    rspec, pspec = _specs("float32")
    client = port_storage.HttpObjectStoreClient(
        s3_stub.url, auth={"mode": "hmac", "key_id": "k", "secret": "s"})
    body = b"payload"
    client.put_bytes("ab/v2-x.npy", body)
    path, headers = seen[-1]
    for verify in (ref_storage.verify_signature,
                   port_storage.verify_signature):
        assert verify("PUT", path, body, headers, {"k": "s"}) is None
    port_storage.HttpObjectStoreClient(
        s3_stub.url, auth={"mode": "bearer", "token": "t0k"}).put_bytes(
            "ab/y", body)
    assert seen[-1][1]["Authorization"] == "Bearer t0k"


def test_g4_auth_knobs_parse_as_reference(monkeypatch):
    from dynamo_tpu.runtime.config import env as ref_env
    from dynamo_tpu_torch.config import env as port_env

    names = ("DYNT_OFFLOAD_BW_FRAC", "DYNT_OFFLOAD_SUBBATCH",
             "DYNT_OFFLOAD_QUEUE_CAP", "DYNT_PIN_TTL_SECS", "DYNT_G4_AUTH",
             "DYNT_G4_HMAC_KEY_ID", "DYNT_G4_HMAC_SECRET",
             "DYNT_G4_BEARER_TOKEN", "DYNT_G4_SIG_TTL_SECS")
    for name in names:
        monkeypatch.delenv(name, raising=False)
        assert port_env(name) == ref_env(name), name
    for name, raw in zip(names, ("0.5", "4", "17", "12.5", "hmac", "id",
                                 "sec", "tok", "60")):
        monkeypatch.setenv(name, raw)
        assert port_env(name) == ref_env(name), name
    monkeypatch.setenv("DYNT_G4_HMAC_KEY_ID", "kid")
    monkeypatch.setenv("DYNT_G4_HMAC_SECRET", "sec")
    client = port_storage.HttpObjectStoreClient("http://127.0.0.1:1/b")
    assert client.auth == {"mode": "hmac", "key_id": "kid", "secret": "sec"}


# -- the offload manager ---------------------------------------------------------


def _offload_pair(sink_fail, **kw):
    """The same OffloadManager setup in both packages: gathers of ones,
    a sink that raises on the hashes `sink_fail` names."""
    out = {}
    for name, mod, make in (
            ("ref", ref, lambda n: np.ones((n, 1), np.float32)),
            ("port", port, lambda n: torch.ones((n, 1)))):
        sunk = []

        def sink(h, d, p, sunk=sunk):
            if sink_fail(h):
                raise RuntimeError("tier full")
            sunk.append(h)

        om = mod.OffloadManager(
            lookup_pages=lambda hs: [1 for _ in hs],
            gather=lambda ids, make=make: make(len(ids)),
            sink=sink, **kw)
        out[name] = (om, sunk)
    return out


@pytest.mark.parametrize("case", [
    dict(fail=lambda h: h >= 3, hashes=[1, 2, 3, 4], batch=4, sub=2),
    dict(fail=lambda h: h == 2, hashes=[1, 2], batch=2, sub=2),
    dict(fail=lambda h: h in (1, 5), hashes=[1, 2, 3, 4, 5, 6], batch=3,
         sub=1),
], ids=["mid-batch", "mid-bundle", "two-batches"])
def test_offload_dropped_ledger_matches_reference(case):
    pair = _offload_pair(case["fail"], run_in_step=None,
                         batch_size=case["batch"], subbatch=case["sub"],
                         bw_frac=0.0, queue_cap=64)
    for om, _ in pair.values():
        om.notify_stored(case["hashes"], parent=None)
    for om, _ in pair.values():
        assert om.flush(5.0)
    (rom, rsunk), (pom, psunk) = pair["ref"], pair["port"]
    assert sorted(psunk) == sorted(rsunk)
    assert pom.dropped == rom.dropped
    assert pom.dropped + len(psunk) == len(case["hashes"])
    # the thread survives: the next batch sinks
    for om, _ in pair.values():
        om.notify_stored([100, 101], parent=None)
        assert om.flush(5.0)
        om.close()
    assert sorted(psunk) == sorted(rsunk)


def test_offload_sink_failure_abandons_the_submitted_gather():
    """A sink raising between a gather's submit and its await abandons the
    queued closure (it no-ops when the scheduler finally runs it), and the
    whole batch counts as dropped, in both packages."""
    results = {}
    for name, mod, make in (("ref", ref, lambda n: np.zeros((n, 1))),
                            ("port", port, lambda n: torch.zeros((n, 1)))):
        queued, gathers = [], []

        def run_in_step(fn, queued=queued):
            out = thread_queue.Queue(1)
            queued.append((fn, out))
            return out

        def gather(ids, gathers=gathers, make=make):
            gathers.append(len(ids))
            return make(len(ids))

        def sink(h, d, p):
            raise RuntimeError("tier full")

        om = mod.OffloadManager(
            lookup_pages=lambda hs: [1 for _ in hs], gather=gather,
            run_in_step=run_in_step, sink=sink, batch_size=4, subbatch=2,
            bw_frac=0.0, queue_cap=64)
        om.notify_stored([1, 2, 3, 4], parent=None)
        deadline = time.monotonic() + 5.0
        while not queued and time.monotonic() < deadline:
            time.sleep(0.005)
        fn, out = queued[0]
        out.put((fn(), None))
        assert om.flush(5.0)
        om.close()
        late = queued[1][0]()
        results[name] = (list(gathers), len(queued), om.dropped,
                         late[0], late[1] is None)
    assert results["port"] == results["ref"] == ([2], 2, 4, [], True)


def test_offload_queue_cap_drops_oldest_as_reference():
    from dynamo_tpu_torch.runtime.metrics import KVBM_OFFLOAD_DROPPED

    gate = threading.Event()
    before = KVBM_OFFLOAD_DROPPED.labels().get()
    pair = {}
    for name, mod, make in (("ref", ref, lambda n: np.zeros((n, 1))),
                            ("port", port, lambda n: torch.zeros((n, 1)))):
        sunk, held = [], threading.Event()

        def lookup(hs, held=held):
            held.set()
            gate.wait(5.0)
            return [1 for _ in hs]

        om = mod.OffloadManager(
            lookup_pages=lookup, gather=lambda ids, make=make: make(len(ids)),
            run_in_step=None, sink=lambda h, d, p, sunk=sunk: sunk.append(h),
            batch_size=2, subbatch=2, bw_frac=0.0, queue_cap=3)
        om.notify_stored([1, 2], parent=None)
        assert held.wait(5.0)  # the worker holds [1, 2] at the gate
        om.notify_stored([3, 4, 5, 6, 7], parent=None)
        pair[name] = (om, sunk)
    gate.set()
    for om, _ in pair.values():
        assert om.flush(5.0)
        om.close()
    assert pair["port"][1] == pair["ref"][1]
    assert pair["port"][0].dropped == pair["ref"][0].dropped == 2
    assert KVBM_OFFLOAD_DROPPED.labels().get() - before == 2


# -- the manager ----------------------------------------------------------------


def _managers(tmp_path, kind="bfloat16", host=2, disk=2, g4=True,
              admission=False):
    rspec, pspec = _specs(kind)
    out = []
    for name, mod, spec in (("ref", ref, rspec), ("port", port, pspec)):
        root = tmp_path / name
        out.append(mod.KvBlockManager(mod.KvbmConfig(
            host_blocks=host, disk_blocks=disk,
            disk_path=str(root / "g3.bin") if disk else None,
            object_store_root=str(root / "g4") if g4 else None,
            admission=admission), spec))
    return out[0], out[1], rspec, pspec


def _usage_and_stats(mgr):
    usage = mgr.usage()
    return usage, dataclasses.asdict(mgr.stats)


@pytest.mark.parametrize("kind,disk,g4", [
    ("float32", 2, False), ("int8", 1, True), ("float32", 0, True),
    ("int8", 2, True)])
def test_manager_cascade_and_promotion_match_reference(tmp_path, kind, disk,
                                                       g4):
    rm, pm, rspec, pspec = _managers(tmp_path, kind, disk=disk, g4=g4)
    words = {h: _words(rspec, h) for h in range(1, 8)}
    for h, w in words.items():
        rm._offload_sink(h, _as_ref(w, rspec), h - 1 or None)
        pm._offload_sink(h, _as_port(w, pspec), h - 1 or None)
        assert pm.usage() == rm.usage()
    hashes = list(words)
    assert pm.match_prefix(hashes) == rm.match_prefix(hashes)
    for run in ([3, 1], [6, 7], hashes, [99], [1, 99]):
        r, p = rm.read_blocks(run), pm.read_blocks(run)
        assert (r is None) == (p is None), run
        if r is not None:
            assert np.array_equal(_bits_port(p), _bits_ref(r))
            assert np.array_equal(
                _bits_port(p), np.stack([words[h] for h in run]))
        assert _usage_and_stats(pm) == _usage_and_stats(rm), run
    rm.close()
    pm.close()


def test_g3_file_is_byte_equal(tmp_path):
    rm, pm, rspec, pspec = _managers(tmp_path, "bfloat16", host=1, disk=3,
                                     g4=False)
    for h in range(1, 5):
        w = _words(rspec, h)
        rm._offload_sink(h, _as_ref(w, rspec), None)
        pm._offload_sink(h, _as_port(w, pspec), None)
    rm.disk.arena._slab.flush()
    pm.disk.arena._slab.flush()
    assert ((tmp_path / "port" / "g3.bin").read_bytes()
            == (tmp_path / "ref" / "g3.bin").read_bytes())
    rm.close()
    pm.close()


def test_pin_leases_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("DYNT_PIN_TTL_SECS", "100")
    rm, pm, rspec, pspec = _managers(tmp_path, "float32", host=2, disk=2,
                                     g4=False)
    for mgr, spec, conv in ((rm, rspec, _as_ref), (pm, pspec, _as_port)):
        mgr._offload_sink(1, conv(_words(rspec, 1), spec), None)
    out = {}
    for name, mgr, spec, conv in (("ref", rm, rspec, _as_ref),
                                  ("port", pm, pspec, _as_port)):
        log = [mgr.pin_blocks([1, 2], ttl=500.0, now=0.0)]  # clamped: 100
        for h in range(3, 8):  # 2 lands pinned-ahead, 1 stays pinned
            mgr._offload_sink(h, conv(_words(rspec, h), spec), None)
            log.append((mgr.host.contains(1), mgr.host.contains(2),
                        mgr.pinned_blocks()))
        log.append(mgr.sweep_pins(now=50.0))
        log.append(mgr.pin_blocks([1], ttl=10.0, now=60.0))  # refresh
        log.append(mgr.sweep_pins(now=99.0))
        log.append(mgr.sweep_pins(now=100.0))
        log.append(mgr.pinned_blocks())
        log.append(mgr.sweep_pins(now=1e9))
        log.append(mgr.usage())
        out[name] = log
    assert out["port"] == out["ref"]
    rm.close()
    pm.close()


def test_park_store_matches_reference(tmp_path):
    rm, pm, rspec, pspec = _managers(tmp_path, "int8", g4=False)
    w = _words(rspec, 3, n=2)
    log = {}
    for name, mgr, bundle in (("ref", rm, w), ("port", pm,
                                               torch.from_numpy(w.copy()))):
        steps = [mgr.park_sequence("a", bundle), mgr.park_sequence("b", bundle),
                 mgr.park_sequence("a", bundle), mgr.parked_count()]
        got = mgr.claim_parked("a")
        steps += [np.array_equal(np.asarray(got), w),
                  mgr.claim_parked("a") is None, mgr.drop_parked("b"),
                  mgr.drop_parked("b"), mgr.parked_count()]
        log[name] = steps
        mgr.close()
    assert log["port"] == log["ref"]


def test_prefetch_promotes_like_reference(tmp_path):
    rm, pm, rspec, pspec = _managers(tmp_path, "bfloat16", host=2, disk=2,
                                     g4=True)
    for h in range(1, 7):
        w = _words(rspec, h)
        rm._offload_sink(h, _as_ref(w, rspec), None)
        pm._offload_sink(h, _as_port(w, pspec), None)
    # bf16: the reference's G4 blobs never read back, so prefetch the G3
    # residents only
    resident = [h for h in range(1, 7) if rm.disk.contains(h)]
    assert resident and resident == [h for h in range(1, 7)
                                     if pm.disk.contains(h)]
    for mgr in (rm, pm):
        mgr.prefetch(resident[:1])
    deadline = time.monotonic() + 5.0
    while not (rm.host.contains(resident[0])
               and pm.host.contains(resident[0])):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert pm.usage() == rm.usage()
    rm.close()
    pm.close()


def test_host_arena_pins_when_asked(monkeypatch):
    _, pspec = _specs("bfloat16")
    calls = []
    real = torch.zeros

    def zeros(*args, **kwargs):
        calls.append(kwargs.get("pin_memory"))
        kwargs.pop("pin_memory", None)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "zeros", zeros)
    arena = port.HostArena(pspec, 3, pin_memory=True)
    assert arena.pinned and calls == [True]
    assert arena.nbytes() == 3 * pspec.block_bytes()
    mgr = port.KvBlockManager(port.KvbmConfig(host_blocks=2), pspec)
    assert mgr.pin_memory is False  # no card here: plain host memory
    mgr.close()
