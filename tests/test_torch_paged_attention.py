"""The port's decode attention (dynamo_tpu_torch.ops.paged_attention) against
the JAX package.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there); here the plain version `paged_decode_attention_pool_ref`
plus `_combine_current` is held against the JAX Pallas kernel in interpret
mode and against JAX's XLA decode attention, on the same numpy inputs.
Tolerances: f32 2e-5 (two frameworks' f32 reduction orders); bf16 outputs
2e-2 (one bf16 ulp at |x| ~ 2 after identical f32 math).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.transformer import paged_attention_decode_xla
from dynamo_tpu_torch.ops import paged_attention as tpa
from jax_capabilities import requires_pallas_compiler_params

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _case(b=4, qh=8, kh=4, hd=64, ps=8, n_pages=32, max_pages=6, n_layers=3,
          seed=5, lens=None):
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(n_layers, 2, n_pages, ps, kh, hd)).astype(np.float32)
    q = rng.normal(size=(b, 1, qh, hd)).astype(np.float32)
    kc = rng.normal(size=(b, 1, kh, hd)).astype(np.float32)
    vc = rng.normal(size=(b, 1, kh, hd)).astype(np.float32)
    ids = rng.permutation(n_pages - 1)[: b * max_pages].reshape(b, max_pages)
    tables = (ids + 1).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, ps * max_pages + 1, size=b)
    return q, kv, tables, np.asarray(lens, np.int32), kc, vc


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrs]


def _torch(arrs, dtype):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrs]


def _port_decode(case, dtype, layer):
    q, kv, tables, lens, kc, vc = _torch(case, dtype)
    out = tpa.paged_attention_decode_pool(q, kv, layer, tables, lens, kc, vc)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kh", [(4, 4), (8, 4), (8, 2)])  # groups 1/2/4
def test_decode_pool_matches_xla(dtype, qh, kh):
    case = _case(qh=qh, kh=kh)
    jq, jkv, jt, jl, jkc, jvc = _jax(case, getattr(jnp, dtype))
    for layer in (0, 1, 2):
        want = np.asarray(paged_attention_decode_xla(
            jq, jkv, layer, jt, jl, jkc, jvc), np.float32)
        got = _port_decode(case, dtype, layer)
        np.testing.assert_allclose(got, want, rtol=_TOL[dtype],
                                   atol=_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_history_and_mixed_lengths(dtype):
    """kv_len == 1 (no history: m = -inf, l = 0 partials) next to page
    boundaries and a full table."""
    ps, max_pages = 8, 6
    lens = [1, 2, ps, ps + 1, ps * max_pages, 1, 3 * ps, 17]
    case = _case(b=len(lens), ps=ps, max_pages=max_pages, n_pages=64,
                 lens=lens, seed=9)
    jq, jkv, jt, jl, jkc, jvc = _jax(case, getattr(jnp, dtype))
    for layer in (0, 2):
        want = np.asarray(paged_attention_decode_xla(
            jq, jkv, layer, jt, jl, jkc, jvc), np.float32)
        got = _port_decode(case, dtype, layer)
        np.testing.assert_allclose(got, want, rtol=_TOL[dtype],
                                   atol=_TOL[dtype])
    q, kv, tables, lens_t, _, _ = _torch(case, dtype)
    acc, m, l = tpa.paged_decode_attention_pool(
        q[:, 0], kv, 1, tables, (lens_t - 1).clamp_min(0))
    empty = (lens_t - 1) == 0
    assert torch.all(torch.isneginf(m[empty]))
    assert torch.all(l[empty] == 0) and torch.all(acc[empty] == 0)
    assert torch.all(torch.isfinite(m[~empty]))


@requires_pallas_compiler_params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kh", [(4, 4), (8, 4), (8, 2)])
def test_partials_match_pallas_interpret(dtype, qh, kh):
    """The plain version's unnormalized partials (acc, m, l) and the combined
    output against the JAX whole-pool kernel run in interpret mode."""
    from dynamo_tpu.ops.paged_attention import (
        paged_attention_decode_pool,
        paged_decode_attention_pool,
    )

    lens = [1, 9, 48, 30]
    case = _case(qh=qh, kh=kh, lens=lens, seed=11)
    jq, jkv, jt, jl, jkc, jvc = _jax(case, getattr(jnp, dtype))
    q, kv, tables, lens_t, kc, vc = _torch(case, dtype)
    tol = _TOL[dtype]
    layer = 1
    j_acc, j_m, j_l = paged_decode_attention_pool(
        jq[:, 0], jkv, layer, jt, jnp.maximum(jl - 1, 0), interpret=True)
    acc, m, l = tpa.paged_decode_attention_pool(
        q[:, 0], kv, layer, tables, (lens_t - 1).clamp_min(0))
    # The partials are f32 in both frameworks, from the same inputs; acc
    # sums up to 48 terms of |p * v| ~ 1.
    np.testing.assert_allclose(m.numpy(), np.asarray(j_m), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), rtol=1e-4,
                               atol=1e-4)
    want = np.asarray(paged_attention_decode_pool(
        jq, jkv, layer, jt, jl, jkc, jvc, interpret=True), np.float32)
    got = tpa.paged_attention_decode_pool(q, kv, layer, tables, lens_t, kc,
                                          vc).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_cpu_tensors_never_count_a_launch():
    tpa.paged_decode_attention_pool.launches = 0
    case = _case()
    q, kv, tables, lens, kc, vc = _torch(case, "bfloat16")
    tpa.paged_attention_decode_pool(q, kv, 0, tables, lens, kc, vc)
    assert tpa.paged_decode_attention_pool.launches == 0


def test_non_cpu_tensors_never_take_the_plain_path():
    """Only tensors on the CPU run the plain version: anything else either
    launches the kernel (CUDA) or raises."""
    q = torch.empty((2, 8, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 2, 4, 8, 4, 64), dtype=torch.bfloat16, device="meta")
    tables = torch.empty((2, 3), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.paged_decode_attention_pool(q, kv, 0, tables, lens)
