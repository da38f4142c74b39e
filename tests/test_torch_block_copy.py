"""The port's page gathers and scatters (`ops/block_copy.py`) and the
runner's page I/O against the JAX package's `ops/block_copy.py`.

The same seeded pool goes through both packages: the universal bundles are
held byte-equal (tolerance 0), bf16 and float32 pools alike; the packed int8
bundle (value bytes, then bf16 scales over 128 lanes) is byte-equal to
`gather_kv_blocks_q8` on a head_dim-128 pool, and scattering either
package's bundle writes the same pool. The runner's `kv_layout` equals the
reference runner's descriptor. A scatter writes into the pool's own
tensors: a decode step captured before it reads the scattered pages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.models import get_config
from dynamo_tpu.ops import block_copy as ref
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig
from dynamo_tpu_torch.ops import block_copy as port

L, P, PS, KH = 2, 11, 4, 2
IDS = np.array([7, 2, 9, 3], np.int32)


def _pool(dtype, hd=8, seed=0):
    """A seeded pool [L, 2, P, ps, kh, hd]: (numpy for JAX, tensor)."""
    x = np.random.default_rng(seed).normal(size=(L, 2, P, PS, KH, hd))
    if dtype == "bfloat16":
        j = jnp.asarray(x, jnp.bfloat16)
        bits = np.asarray(j).view(np.uint16)
        return j, torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    x = x.astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _bytes_np(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _bytes_t(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _q8_pool(seed=1):
    """An int8 pool at head_dim 128: values, one bf16 scale per token
    (port) and the same scale over 128 lanes (reference)."""
    rng = np.random.default_rng(seed)
    values = rng.integers(-127, 128, (L, 2, P, PS, KH, 128)).astype(np.int8)
    scales = jnp.asarray(rng.uniform(0.01, 2.0, (L, 2, P, PS)), jnp.bfloat16)
    lanes = jnp.broadcast_to(scales[..., None], scales.shape + (128,))
    port_scales = torch.from_numpy(
        np.asarray(scales).view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return values, lanes, port_scales


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_is_byte_equal(dtype):
    jpool, tpool = _pool(dtype)
    want = ref.gather_kv_blocks(jpool, jnp.asarray(IDS))
    got = port.gather_kv_blocks(tpool, IDS)
    assert tuple(got.shape) == want.shape == (len(IDS), L, 2, PS, KH, 8)
    assert np.array_equal(_bytes_t(got), _bytes_np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_writes_the_reference_pool(dtype):
    jpool, tpool = _pool(dtype)
    jsrc, tsrc = _pool(dtype, seed=5)
    bundle_j = ref.gather_kv_blocks(jsrc, jnp.asarray(IDS))
    bundle_t = port.gather_kv_blocks(tsrc, IDS)
    target = np.array([1, 4, 5, 10], np.int32)
    want = ref.scatter_kv_blocks(jpool, jnp.asarray(target), bundle_j)
    storage = tpool.data_ptr()
    got = port.scatter_kv_blocks(tpool, target, bundle_t)
    assert got is tpool and tpool.data_ptr() == storage  # in place
    assert np.array_equal(_bytes_t(tpool), _bytes_np(want))


def test_packed_q8_gather_is_byte_equal():
    values, lanes, scales = _q8_pool()
    want = np.asarray(ref.gather_kv_blocks_q8(
        jnp.asarray(values), lanes, jnp.asarray(IDS)))
    got = port.gather_kv_blocks_q8(torch.from_numpy(values), scales, IDS)
    # value bytes, then 128 bf16 lanes per token: 1 B per value, 256 B per
    # token's scale row
    assert want.shape == (len(IDS), L * 2 * PS * (KH * 128 + 128 * 2))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", ["port", "ref"])
def test_packed_q8_scatter_is_the_inverse(side):
    """Either package's packed bundle scattered by the port writes the
    reference's pool: the values equal, the scale equal to lane 0."""
    values, lanes, scales = _q8_pool()
    if side == "ref":
        packed = torch.from_numpy(np.array(ref.gather_kv_blocks_q8(
            jnp.asarray(values), lanes, jnp.asarray(IDS))))
    else:
        packed = port.gather_kv_blocks_q8(torch.from_numpy(values), scales,
                                          IDS)
    target = np.array([1, 4, 5, 10], np.int32)
    dv, dl, ds = _q8_pool(seed=3)
    want_v, want_s = ref.scatter_kv_blocks_q8(
        jnp.asarray(dv), dl, jnp.asarray(target), jnp.asarray(packed.numpy()))
    tv = torch.from_numpy(dv.copy())
    ptrs = (tv.data_ptr(), ds.data_ptr())
    port.scatter_kv_blocks_q8(tv, ds, target, packed)
    assert (tv.data_ptr(), ds.data_ptr()) == ptrs
    assert np.array_equal(tv.numpy(), np.asarray(want_v))
    assert np.array_equal(_bytes_t(ds), _bytes_np(np.asarray(want_s)[..., 0]))


def test_packed_q8_scatter_refuses_unequal_lanes():
    values, lanes, scales = _q8_pool()
    packed = port.gather_kv_blocks_q8(torch.from_numpy(values), scales, IDS)
    # bump one scale lane of page 0's last token
    packed[0, -1] ^= 1
    with pytest.raises(ValueError, match="lanes"):
        port.scatter_kv_blocks_q8(torch.from_numpy(values.copy()),
                                  scales.clone(), IDS, packed)
    with pytest.raises(ValueError, match="uint8"):
        port.scatter_kv_blocks_q8(torch.from_numpy(values.copy()),
                                  scales.clone(), IDS, packed[:, :-2])


@pytest.mark.parametrize("n", [1, 3, 4, 5, 9])
def test_pad_bundle_pow2_matches(n):
    ids = np.arange(n, dtype=np.int32) + 3
    blocks = np.random.default_rng(n).normal(size=(n, 2, 3)).astype(
        np.float32)
    want = ref.pad_bundle_pow2(ids, blocks)
    got = port.pad_bundle_pow2(ids, blocks)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_scatter_from_host_matches_the_reference():
    jpool, tpool = _pool("float32")
    src = np.random.default_rng(9).normal(
        size=(2, L, 2, PS, KH, 8)).astype(np.float32)
    want = ref.scatter_from_host(jpool, np.array([2, 6]), src)
    port.scatter_from_host(tpool, [2, 6], torch.from_numpy(src))
    assert np.array_equal(tpool.numpy(), np.asarray(want))


# -- the runner's page I/O ---------------------------------------------------

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=32, max_batch=2, max_pages_per_seq=8,
              prefill_buckets=(8, 16))


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_kv_layout_equals_the_reference(kv_dtype):
    cfg = CFG if kv_dtype == "model" else dataclasses.replace(
        CFG, head_dim=128)
    rc = dict(RUNNER, kv_dtype=kv_dtype)
    mine = ModelRunner(cfg, RunnerConfig(**rc), device="cpu").kv_layout()
    theirs = JRunner(cfg, JRunnerConfig(**rc), make_mesh(MeshConfig()),
                     seed=0).kv_layout()
    assert mine == theirs


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_runner_gather_then_scatter_round_trips(kv_dtype):
    cfg = CFG if kv_dtype == "model" else dataclasses.replace(
        CFG, head_dim=128)
    runner = ModelRunner(cfg, RunnerConfig(**RUNNER, kv_dtype=kv_dtype),
                         device="cpu")
    table = np.arange(1, 9, dtype=np.int32)
    runner.prefill_chunk(np.arange(3, 14, dtype=np.int32), 0, table, 11,
                         (0.0, 1.0, 0, 0))
    host = runner.gather_pages([1, 2, 3])
    staged = runner.stage_bundle(host)
    runner.scatter_pages(np.array([20, 21, 22], np.int32), staged)
    again = runner.gather_pages([20, 21, 22])
    assert torch.equal(host, again)
    assert torch.equal(runner.gather_pages([20, 21, 22]).view(torch.uint8),
                       runner.gather_pages([1, 2, 3]).view(torch.uint8))


def test_scatter_in_place_feeds_a_captured_decode():
    """The decode graph is captured (on the card: its graph records the
    pool's storage) BEFORE pages are scattered into the pool: its next
    replay must read the scattered pages, as a fresh prefill would have
    written them. Greedy tokens and logits equal the source's (tolerance
    0: the same pages, the same step)."""
    params_src = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu")
    dst = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                      params=params_src.model)
    b, p = RUNNER["max_batch"], RUNNER["max_pages_per_seq"]
    prompt = np.arange(5, 18, dtype=np.int32)  # 13 tokens: 4 pages
    table = np.zeros(p, np.int32)
    table[:4] = [1, 2, 3, 4]

    def decode(runner, tbl):
        tables = np.zeros((b, p), np.int32)
        tables[0] = tbl
        return runner.decode(
            np.array([int(prompt[-1]), 0], np.int32),
            np.array([len(prompt) - 1, 0], np.int32), tables,
            np.array([len(prompt), 0], np.int32), np.array([True, False]),
            np.zeros(b, np.float32), np.ones(b, np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.uint32),
            want_logits=True, logits_slots=[0])

    params_src.prefill_chunk(prompt, 0, table, len(prompt),
                             (0.0, 1.0, 0, 0))
    want_tok = decode(params_src, table)
    want_logits = params_src.last_decode_logits.copy()
    # dst captures its decode key now, then receives the pages elsewhere
    dst_table = np.zeros(p, np.int32)
    dst_table[:4] = [9, 10, 11, 12]
    decode(dst, dst_table)
    assert dst.graph_captures >= 1
    storage = dst.kv_cache.data_ptr()
    dst.scatter_pages(dst_table[:4], dst.stage_bundle(
        params_src.gather_pages(table[:4])))
    assert dst.kv_cache.data_ptr() == storage
    captures = dst.graph_captures
    got_tok = decode(dst, dst_table)
    assert dst.graph_captures == captures  # a replay, not a new capture
    assert int(got_tok[0]) == int(want_tok[0])
    assert np.array_equal(dst.last_decode_logits, want_logits)
