"""The port's int8 KV pool against the JAX package's.

The reference stores (values int8 [L, 2, P, ps, kh, hd], scales bf16
[L, 2, P, ps, 128]) with each token's scale broadcast over 128 lanes; the
port stores one scale per token, [L, 2, P, ps], and `kv_cache_from_numpy`
takes lane 0 of a JAX pool. Checked here, on the same numpy inputs:
`quantize_kv` is bit-identical (scale = JAX lane 0); the int8 write paths
write the same bytes; the int8 plain attentions and the plain version of
the int8 decode kernel match JAX (its kernel run in interpret mode).
Tolerances: f32 outputs 2e-5 (f32 reduction orders), bf16 outputs 2e-2
(one bf16 ulp at |x| ~ 2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import get_config
from dynamo_tpu.models import transformer as jt
from dynamo_tpu_torch.models import kv_cache_from_numpy
from dynamo_tpu_torch.models import transformer as tt
from dynamo_tpu_torch.ops import paged_attention as tpa
from jax_capabilities import requires_pallas_compiler_params

CFG = dataclasses.replace(get_config("tiny-test"), n_q_heads=8, n_kv_heads=2,
                          head_dim=128, n_layers=3)
PS, PAGES, MAX_PAGES, B, T = 4, 40, 6, 3, 7
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _kv_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    k[..., 0, :, :] = 0.0  # an all-zero token: scale 0, codes 0
    return k, v


def _tables(seed):
    rng = np.random.default_rng(seed)
    return (rng.permutation(PAGES - 1)[: B * MAX_PAGES]
            .reshape(B, MAX_PAGES) + 1).astype(np.int32)


def _port_pool(j_pool):
    return kv_cache_from_numpy((np.asarray(j_pool[0]), np.asarray(j_pool[1])),
                               device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical(dtype):
    x = np.random.default_rng(0).normal(size=(3, 5, 2, 128)).astype(
        np.float32) * 3
    x[1, 2] = 0.0
    jq, js = jt.quantize_kv(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = tt.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == js.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js[..., 0], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_paths_bit_equal(dtype):
    tables = _tables(1)
    positions = np.stack([np.arange(3, 3 + T)] * B).astype(np.int32)
    valid = np.ones((B, T), bool)
    valid[1, 4:] = False
    k, v = _kv_inputs(2, (CFG.n_layers, B, T, CFG.n_kv_heads, CFG.head_dim))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    targs = (torch.from_numpy(tables), torch.from_numpy(positions).long(),
             torch.from_numpy(valid))
    jargs = (jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(valid))

    j_pool = jt.write_kv_pages(jt.make_kv_cache_int8(CFG, PAGES, PS), 1,
                               jnp.asarray(k[0], jdt), jnp.asarray(v[0], jdt),
                               *jargs)
    pool = tt.make_kv_cache_int8(CFG, PAGES, PS, device="cpu")
    out = tt.write_kv_pages(pool, 1, torch.from_numpy(k[0]).to(tdt),
                            torch.from_numpy(v[0]).to(tdt), *targs)
    assert out is pool  # in place
    want = _port_pool(j_pool)
    np.testing.assert_array_equal(pool[0].numpy()[:, :, 1:],
                                  want[0].numpy()[:, :, 1:])
    np.testing.assert_array_equal(pool[1].float().numpy()[:, :, 1:],
                                  want[1].float().numpy()[:, :, 1:])

    j_pool = jt.write_kv_stack(jt.make_kv_cache_int8(CFG, PAGES, PS),
                               jnp.asarray(k, jdt), jnp.asarray(v, jdt), *jargs)
    pool = tt.write_kv_stack(tt.make_kv_cache_int8(CFG, PAGES, PS,
                                                   device="cpu"),
                             torch.from_numpy(k).to(tdt),
                             torch.from_numpy(v).to(tdt), *targs)
    want = _port_pool(j_pool)
    np.testing.assert_array_equal(pool[0].numpy()[:, :, 1:],
                                  want[0].numpy()[:, :, 1:])
    np.testing.assert_array_equal(pool[1].float().numpy()[:, :, 1:],
                                  want[1].float().numpy()[:, :, 1:])


def _filled_pool(seed):
    """A JAX int8 pool with every layer's pages written, and the port's
    copy of it."""
    rng = np.random.default_rng(seed)
    tables = _tables(seed)
    n_tok = MAX_PAGES * PS
    k, v = _kv_inputs(seed, (CFG.n_layers, B, n_tok, CFG.n_kv_heads,
                             CFG.head_dim))
    positions = np.tile(np.arange(n_tok, dtype=np.int32), (B, 1))
    j_pool = jt.write_kv_stack(
        jt.make_kv_cache_int8(CFG, PAGES, PS), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(positions),
        jnp.ones((B, n_tok), bool))
    return rng, tables, j_pool, _port_pool(j_pool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attentions_match_jax(dtype):
    rng, tables, j_pool, pool = _filled_pool(3)
    qh, kh, hd = CFG.n_q_heads, CFG.n_kv_heads, CFG.head_dim
    jdt, tdt, tol = getattr(jnp, dtype), getattr(torch, dtype), _TOL[dtype]
    # prefill: a chunk of T queries at the end of each sequence's history
    lens = np.asarray([9, 24, 17], np.int32)
    positions = (lens[:, None] - T + np.arange(T)[None, :]).astype(np.int32)
    q = rng.normal(size=(B, T, qh, hd)).astype(np.float32)
    for layer in (0, 2):
        want = np.asarray(jt.paged_attention_xla(
            jnp.asarray(q, jdt), j_pool, layer, jnp.asarray(tables),
            jnp.asarray(positions), jnp.asarray(lens)), np.float32)
        got = tt.paged_attention_xla(
            torch.from_numpy(q).to(tdt), pool, layer,
            torch.from_numpy(tables), torch.from_numpy(positions).long(),
            torch.from_numpy(lens)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # decode: history + the in-register current token (kv_len 1 = none)
    lens = np.asarray([1, 13, 24], np.int32)
    q1 = rng.normal(size=(B, 1, qh, hd)).astype(np.float32)
    kc = rng.normal(size=(B, 1, kh, hd)).astype(np.float32)
    vc = rng.normal(size=(B, 1, kh, hd)).astype(np.float32)
    for layer in (1, 2):
        want = np.asarray(jt.paged_attention_decode_xla(
            jnp.asarray(q1, jdt), j_pool, layer, jnp.asarray(tables),
            jnp.asarray(lens), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt)),
            np.float32)
        args = (torch.from_numpy(q1).to(tdt), pool, layer,
                torch.from_numpy(tables), torch.from_numpy(lens),
                torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt))
        for fn in (tt.paged_attention_decode_xla,
                   tpa.paged_attention_decode_pool):
            got = fn(*args).float().numpy()
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@requires_pallas_compiler_params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_plain_version_matches_pallas_interpret(dtype):
    """The int8 decode kernel's plain version: unnormalized partials and the
    combined output against the JAX kernel's quantized branch in interpret
    mode (hd 128, the geometry the reference kernel takes)."""
    from dynamo_tpu.ops.paged_attention import (
        paged_attention_decode_pool,
        paged_decode_attention_pool,
    )

    rng, tables, j_pool, pool = _filled_pool(4)
    qh, kh, hd = CFG.n_q_heads, CFG.n_kv_heads, CFG.head_dim
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    lens = np.asarray([1, 10, 24], np.int32)
    hist = np.maximum(lens - 1, 0)
    q = rng.normal(size=(B, 1, qh, hd)).astype(np.float32)
    kc = rng.normal(size=(B, 1, kh, hd)).astype(np.float32)
    vc = rng.normal(size=(B, 1, kh, hd)).astype(np.float32)
    layer = 1
    j_acc, j_m, j_l = paged_decode_attention_pool(
        jnp.asarray(q[:, 0], jdt), j_pool[0], layer, jnp.asarray(tables),
        jnp.asarray(hist), kv_scales=j_pool[1], interpret=True)
    acc, m, l = tpa.paged_decode_attention_pool(
        torch.from_numpy(q[:, 0]).to(tdt), pool[0], layer,
        torch.from_numpy(tables), torch.from_numpy(hist), kv_scales=pool[1])
    live = hist > 0
    assert torch.all(torch.isneginf(m[~live])) and torch.all(l[~live] == 0)
    assert torch.all(acc[~live] == 0)
    np.testing.assert_allclose(m.numpy()[live], np.asarray(j_m)[live],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.numpy()[live], np.asarray(j_l)[live],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), rtol=1e-4,
                               atol=1e-4)
    want = np.asarray(paged_attention_decode_pool(
        jnp.asarray(q, jdt), j_pool, layer, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        interpret=True), np.float32)
    got = tpa.paged_attention_decode_pool(
        torch.from_numpy(q).to(tdt), pool, layer, torch.from_numpy(tables),
        torch.from_numpy(lens), torch.from_numpy(kc).to(tdt),
        torch.from_numpy(vc).to(tdt)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=_TOL[dtype], atol=_TOL[dtype])


def test_kv_cache_from_numpy_checks_the_lanes():
    values, scales = jt.make_kv_cache_int8(CFG, 4, PS)
    scales = np.array(scales)
    scales[0, 1, 2, 3, 5] = 1.0  # one lane differs from its row's lane 0
    with pytest.raises(ValueError, match="lanes"):
        kv_cache_from_numpy((np.asarray(values), scales), device="cpu")


def test_cpu_tensors_never_count_a_launch():
    tpa.paged_decode_attention_pool_int8.launches = 0
    _, tables, _, pool = _filled_pool(5)
    q = torch.ones((B, CFG.n_q_heads, CFG.head_dim), dtype=torch.bfloat16)
    tpa.paged_decode_attention_pool(q, pool[0], 0, torch.from_numpy(tables),
                                    torch.full((B,), 5, dtype=torch.int32),
                                    kv_scales=pool[1])
    assert tpa.paged_decode_attention_pool_int8.launches == 0


def test_non_cpu_tensors_never_take_the_plain_path():
    q = torch.empty((2, 8, 128), dtype=torch.bfloat16, device="meta")
    values = torch.empty((1, 2, 4, 8, 2, 128), dtype=torch.int8, device="meta")
    scales = torch.empty((1, 2, 4, 8), dtype=torch.bfloat16, device="meta")
    tables = torch.empty((2, 3), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.paged_decode_attention_pool(q, values, 0, tables, lens,
                                        kv_scales=scales)
