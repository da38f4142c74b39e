"""The port's KV transfer protocol (`llm/kv_transfer.py`) against the JAX
package's: frames, assembly, the transfer table and streaming transfers.

Frames are compared byte for byte (tolerance 0: the dicts, their raw
payloads and their msgpack encodings); each package's assembler reads the
other's frames, float32 and bfloat16 bundles alike (the port carries bf16 as
raw bytes, with no `ml_dtypes`). A packed int8 bundle is assembled by its
byte geometry in the port, where the reference's assembler raises
`ValueError` (pinned). The table releases each transfer's pages exactly
once, whether it is claimed, expires, or its streaming prefill fails.
"""

import threading

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.llm import kv_transfer as ref
from dynamo_tpu_torch.llm import kv_transfer as port
from dynamo_tpu_torch.runtime import msgpack as port_msgpack


def _layouts(**kw):
    fields = {"n_layers": 2, "kv_heads": 2, "head_dim": 8, "page_size": 4,
              "dtype": "float32", **kw}
    return ref.KvLayoutDescriptor(**fields), port.KvLayoutDescriptor(**fields)


def _bundle(dtype: str, n=5):
    """A seeded bundle [n, 2, 2, 4, 2, 8]: (numpy for the reference,
    tensor for the port), the same bytes."""
    x = np.random.default_rng(n).normal(size=(n, 2, 2, 4, 2, 8))
    if dtype == "bfloat16":
        j = np.asarray(jnp.asarray(x, jnp.bfloat16))
        t = torch.from_numpy(j.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
        return j, t
    x = x.astype(np.float32)
    return x, torch.from_numpy(x.copy())


def _tbytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("streamed", [False, True])
def test_frames_are_byte_equal(dtype, streamed, monkeypatch):
    rl, pl = _layouts(dtype=dtype)
    # 3 pages a frame: 8 pages make frames of 3, 3 and 2
    monkeypatch.setattr(ref, "TRANSFER_CHUNK_BYTES", rl.page_bytes() * 3)
    monkeypatch.setattr(port, "TRANSFER_CHUNK_BYTES", pl.page_bytes() * 3)
    assert rl.page_bytes() == pl.page_bytes()
    nb, tb = _bundle(dtype, 8)
    kw = dict(base=4, total_pages=12) if streamed else {}
    want = list(ref.encode_block_chunks(nb, rl, **kw))
    got = list(port.encode_block_chunks(tb, pl, **kw))
    assert [f["page_count"] for f in got] == [3, 3, 2]
    assert got == want
    assert [port_msgpack.packb(f) for f in got] == [
        msgpack.packb(f, use_bin_type=True) for f in want]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_assembler_reads_the_others_frames(dtype, monkeypatch):
    rl, pl = _layouts(dtype=dtype)
    monkeypatch.setattr(ref, "TRANSFER_CHUNK_BYTES", rl.page_bytes() * 2)
    monkeypatch.setattr(port, "TRANSFER_CHUNK_BYTES", pl.page_bytes() * 2)
    nb, tb = _bundle(dtype, 5)
    # the port reads the reference's frames, in any order
    asm = port.BlockAssembler()
    for frame in reversed(list(ref.encode_block_chunks(nb, rl))):
        asm.add(frame)
    assert asm.complete
    out, layout = asm.assemble()
    assert layout == pl
    assert out.dtype == port.TORCH_DTYPES[dtype]
    assert tuple(out.shape) == nb.shape
    assert _tbytes(out) == nb.tobytes()
    # the reference reads the port's
    rasm = ref.BlockAssembler()
    for frame in port.encode_block_chunks(tb, pl):
        rasm.add(frame)
    rout, rlayout = rasm.assemble()
    assert rlayout == rl
    assert rout.tobytes() == _tbytes(tb)


def test_incomplete_and_mismatched_transfers_raise():
    _, pl = _layouts()
    _, tb = _bundle("float32", 4)
    frames = list(port.encode_block_chunks(tb, pl))
    asm = port.BlockAssembler()
    assert not asm.complete
    with pytest.raises(ValueError, match="incomplete"):
        asm.assemble()
    asm.add(frames[0])
    other = dict(frames[0], layout=dict(frames[0]["layout"], page_size=8))
    with pytest.raises(ValueError, match="layout changed"):
        asm.add(other)
    short = port.BlockAssembler()
    short.add(dict(frames[0], data=frames[0]["data"][:-4]))
    with pytest.raises(ValueError, match="bytes"):
        short.assemble()
    assert not pl.compatible(port.KvLayoutDescriptor(
        n_layers=2, kv_heads=2, head_dim=8, page_size=8, dtype="float32"))


def test_packed_int8_bundle_assembles_where_the_reference_raises():
    """The reference's fault, pinned: 3 packed pages (L=2, ps=4, kh=2,
    hd=128, float32 layout dtype, int8 with 128 scale lanes). Its
    `page_bytes` sizes pages by the layout dtype and its assembler reshapes
    the bytes as float32 [3, 2, 2, 4, 2, 128]: ValueError. The port sizes
    and assembles packed pages by their bytes."""
    fields = dict(n_layers=2, kv_heads=2, head_dim=128, page_size=4,
                  dtype="float32", kv_dtype="int8", scale_lanes=128)
    rl, pl = ref.KvLayoutDescriptor(**fields), port.KvLayoutDescriptor(
        **fields)
    packed_bytes = 2 * 2 * 4 * (2 * 128 + 128 * 2)  # values, then scales
    assert pl.page_bytes() == packed_bytes
    assert rl.page_bytes() == 2 * 2 * 4 * 2 * 128 * 4  # the reference's
    bundle = np.random.default_rng(0).integers(
        0, 256, (3, packed_bytes)).astype(np.uint8)
    frames = list(port.encode_block_chunks(torch.from_numpy(bundle), pl))
    assert frames == list(ref.encode_block_chunks(bundle, rl))  # one frame
    asm = port.BlockAssembler()
    for f in frames:
        asm.add(f)
    out, layout = asm.assemble()
    assert layout.packed and out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), bundle)
    rasm = ref.BlockAssembler()
    for f in frames:
        rasm.add(f)
    with pytest.raises(ValueError, match="cannot reshape"):
        rasm.assemble()


def test_layout_wire_round_trip_and_equality():
    rl, pl = _layouts(kv_dtype="int8", scale_lanes=128)
    assert pl.to_wire() == rl.to_wire()
    assert port.KvLayoutDescriptor.from_wire(
        {**rl.to_wire(), "unknown": 1}) == pl
    assert pl.torch_dtype() == torch.uint8 and pl.page_shape() == (
        pl.page_bytes(),)
    assert _layouts()[1].torch_dtype() == torch.float32


# -- the transfer table ------------------------------------------------------


def _pending(tid, released, table=None, streaming=False, prompt_len=8):
    _, pl = _layouts()
    kw = dict(transfer_id=tid, page_ids=[1, 2], layout=pl,
              prompt_len=prompt_len,
              release=lambda: released.append(tid))
    if streaming:
        return port.StreamingTransfer(table=table, **kw)
    return port.PendingTransfer(**kw)


def test_expiry_releases_once_and_excludes_claims():
    released = []
    table = port.PendingTransferTable(ttl_secs=0.0)
    table.add(_pending("t1", released))
    table.add(_pending("t2", released))
    claimed = table.claim("t2")
    assert claimed is not None and table.claim("t2") is None
    assert table.expire_stale() == 1
    assert released == ["t1"]
    assert table.expire_stale() == 0 and len(table) == 0
    claimed.release()  # the claimer's one release
    assert released == ["t1", "t2"]


def test_ttl_keeps_fresh_entries_and_expire_all_takes_them():
    released = []
    table = port.PendingTransferTable()
    assert table.ttl_secs == 120.0  # the reference's TTL
    table.add(_pending("t1", released))
    assert table.expire_stale() == 0
    assert table.expire_all() == 1 and released == ["t1"]


def test_a_live_streaming_transfer_never_expires():
    released = []
    table = port.PendingTransferTable(ttl_secs=0.0)
    st = _pending("s1", released, table=table, streaming=True)
    table.add(st)
    assert table.expire_stale() == 0  # prompt pass still running
    st.finish(5, [1, 2, 3])
    assert table.expire_stale() == 1 and released == ["s1"]


def test_a_failed_stream_releases_once_unless_claimed():
    released = []
    table = port.PendingTransferTable()
    st = _pending("s1", released, table=table, streaming=True)
    table.add(st)
    st.fail()
    st.fail()  # a repeated abort does nothing
    assert released == ["s1"] and len(table) == 0
    st.append_pages([9])  # late chunks drop
    assert st.page_ids == [1, 2]
    # claimed by a puller first: the puller owns the release
    st2 = _pending("s2", released, table=table, streaming=True)
    table.add(st2)
    assert table.claim("s2") is st2
    st2.fail()
    assert released == ["s1"]
    ids, done, failed = st2.wait_ready(0, 0.01)
    assert failed and not done


def test_streaming_wait_ready_wakes_on_chunks_and_finish():
    table = port.PendingTransferTable()
    st = _pending("s", [], table=table, streaming=True, prompt_len=10)
    assert st.total_pages == 3
    seen = []

    def puller():
        have = 2
        while True:
            ids, done, failed = st.wait_ready(have, 5.0)
            seen.append((list(ids), done))
            have = len(ids)
            if done or failed:
                return

    t = threading.Thread(target=puller)
    t.start()
    st.append_pages([3])
    st.finish(42, [1, 2, 3])
    st.finish(43, [1])  # the first terminal event wins
    t.join(10)
    assert not t.is_alive()
    assert seen[-1] == ([1, 2, 3], True)
    assert st.first_token == 42
