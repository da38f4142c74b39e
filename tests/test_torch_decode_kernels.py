"""Kernel rows 3 and 4 and the speculative attention functions of the port
(dynamo_tpu_torch.ops.paged_attention) against the JAX package.

The CUDA kernels run only on the card (chip_smoke.py holds each against its
plain version there). Here, on the same numpy inputs, the plain versions
are held against the JAX Pallas kernels run in interpret mode and against
the JAX package's XLA oracles:

  * row 3, `paged_decode_attention` (normalized, lengths including the
    current token): Pallas `_decode_kernel`; XLA `paged_attention_xla` at
    the current token's position;
  * row 4, `paged_decode_attention_partial` (unnormalized partials over the
    history): Pallas `_decode_kernel_partial`; through
    `paged_attention_decode_fused`, XLA `paged_attention_decode_xla`;
  * `paged_attention_spec_pool` (rows 1 / 2 at the folded width) and
    `paged_attention_spec` (row 4 folded): XLA `paged_attention_spec_xla`,
    T = 1..5, bf16 and int8 pools (their Pallas interpret-mode comparisons
    are in test_torch_spec.py, to keep each file's run short).

Lengths cover 0 (an inactive slot), 1, a page boundary and the full table.
Tolerances: f32 2e-5 (two frameworks' f32 reduction orders; acc partials,
sums of up to 24 terms |p * v| ~ 1, 1e-4); bf16 outputs 2e-2 (one bf16 ulp
at |x| ~ 2 after identical f32 math); int8 pools 2e-2 in f32 (the reference's
own tolerance for its q8 spec kernel against the XLA dequant oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import transformer as jt
from dynamo_tpu_torch.models import kv_cache_from_numpy
from dynamo_tpu_torch.ops import paged_attention as tpa
from jax_capabilities import requires_pallas_compiler_params

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PS, MAX_PAGES, N_PAGES, N_LAYERS = 4, 6, 40, 3
# lengths: an inactive slot, one token, a page boundary, a page and one,
# the full table
LENS = [0, 1, PS, PS + 1, PS * MAX_PAGES]


def _case(qh=8, kh=2, hd=64, t=1, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    b = len(lens)
    kv = rng.normal(size=(N_LAYERS, 2, N_PAGES, PS, kh, hd)).astype(np.float32)
    q = rng.normal(size=(b, t, qh, hd)).astype(np.float32)
    kc = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    vc = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    tables = (rng.permutation(N_PAGES - 1)[: b * MAX_PAGES]
              .reshape(b, MAX_PAGES) + 1).astype(np.int32)
    return q, kv, tables, np.asarray(lens, np.int32), kc, vc


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrs]


def _torch(arrs, dtype):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrs]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# -- row 3: normalized decode over one layer's slices ------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kh", [(4, 4), (8, 2)])  # groups 1 and 4
def test_row3_matches_xla_attention(dtype, qh, kh):
    """The unified forward's decode: the current token is already in the
    pool, so attention over positions <= kv_len - 1 is JAX's
    `paged_attention_xla` at that position."""
    case = _case(qh=qh, kh=kh)
    jq, jkv, jtab, jlens, _, _ = _jax(case, getattr(jnp, dtype))
    q, kv, tables, lens, _, _ = _torch(case, dtype)
    live = case[3] > 0
    for layer in (0, 2):
        got = tpa.paged_decode_attention(q[:, 0], kv[layer, 0], kv[layer, 1],
                                         tables, lens)
        assert got.dtype == q.dtype and got.shape == q[:, 0].shape
        want = jt.paged_attention_xla(jq, jkv, layer, jtab,
                                      (jlens - 1)[:, None], jlens)[:, 0]
        _close(got[live], np.asarray(_np(want))[live], _TOL[dtype])
        # an inactive slot (length 0) attends to nothing and writes 0
        assert torch.all(got[~live] == 0)


@requires_pallas_compiler_params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row3_matches_pallas_interpret(dtype):
    from dynamo_tpu.ops.paged_attention import paged_decode_attention

    case = _case()
    jq, jkv, jtab, jlens, _, _ = _jax(case, getattr(jnp, dtype))
    q, kv, tables, lens, _, _ = _torch(case, dtype)
    layer = 1
    want = paged_decode_attention(jq[:, 0], jkv[layer, 0], jkv[layer, 1],
                                  jtab, jlens, interpret=True)
    got = tpa.paged_decode_attention(q[:, 0], kv[layer, 0], kv[layer, 1],
                                     tables, lens)
    _close(got, want, _TOL[dtype])


# -- row 4: partials over one layer's history --------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kh", [(4, 4), (8, 2)])
def test_row4_decode_fused_matches_xla(dtype, qh, kh):
    """`paged_attention_decode_fused` (row 4 + the current-token combine)
    against JAX's deferred-write decode attention; kv_len = history + 1."""
    case = _case(qh=qh, kh=kh, lens=[n + 1 for n in LENS])
    jq, jkv, jtab, jlens, jkc, jvc = _jax(case, getattr(jnp, dtype))
    q, kv, tables, lens, kc, vc = _torch(case, dtype)
    for layer in (0, 2):
        want = jt.paged_attention_decode_xla(jq, jkv, layer, jtab, jlens,
                                             jkc, jvc)
        got = tpa.paged_attention_decode_fused(q, kv, layer, tables, lens,
                                               kc, vc)
        _close(got, want, _TOL[dtype])
    acc, m, l = tpa.paged_decode_attention_partial(
        q[:, 0], kv[1, 0], kv[1, 1], tables, lens - 1)
    empty = (lens - 1) == 0
    assert torch.all(torch.isneginf(m[empty]))
    assert torch.all(l[empty] == 0) and torch.all(acc[empty] == 0)
    assert torch.all(torch.isfinite(m[~empty]))


@requires_pallas_compiler_params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row4_partials_match_pallas_interpret(dtype):
    from dynamo_tpu.ops.paged_attention import paged_decode_attention_partial

    case = _case()
    jq, jkv, jtab, jlens, _, _ = _jax(case, getattr(jnp, dtype))
    q, kv, tables, lens, _, _ = _torch(case, dtype)
    layer = 2
    j_acc, j_m, j_l = paged_decode_attention_partial(
        jq[:, 0], jkv[layer, 0], jkv[layer, 1], jtab, jlens, interpret=True)
    acc, m, l = tpa.paged_decode_attention_partial(
        q[:, 0], kv[layer, 0], kv[layer, 1], tables, lens)
    _close(m, j_m, 2e-5)
    _close(l, j_l, 2e-5)
    _close(acc, j_acc, 1e-4)


def test_partial_ref_is_the_pool_ref_on_a_layer_slice():
    """Rows 1 and 4 compute the same partials; the pool kernel only finds
    the layer itself."""
    q, kv, tables, lens, _, _ = _torch(_case(), "float32")
    for got, want in zip(
            tpa.paged_decode_attention_partial(q[:, 0], kv[2, 0], kv[2, 1],
                                               tables, lens),
            tpa.paged_decode_attention_pool(q[:, 0], kv, 2, tables, lens)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- speculative verification attention --------------------------------------


def _int8_pools(case):
    """The same K/V quantized by JAX: (JAX pair, port pair)."""
    j_pair = jt.quantize_kv(jnp.asarray(case[1]))
    return j_pair, kv_cache_from_numpy(
        (np.asarray(j_pair[0]), np.asarray(j_pair[1])), device="cpu")


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_attention_matches_xla(t, dtype):
    """Both drop-ins against JAX's `paged_attention_spec_xla`; kv_len is the
    committed length including chunk token 0 (1 = no history)."""
    case = _case(t=t, lens=[n + 1 for n in LENS])
    jq, jkv, jtab, jlens, jkc, jvc = _jax(case, getattr(jnp, dtype))
    q, kv, tables, lens, kc, vc = _torch(case, dtype)
    want = jt.paged_attention_spec_xla(jq, jkv, 1, jtab, jlens, jkc, jvc)
    for fn in (tpa.paged_attention_spec_pool, tpa.paged_attention_spec):
        got = fn(q, kv, 1, tables, lens, kc, vc)
        assert got.shape == q.shape and got.dtype == q.dtype
        _close(got, want, _TOL[dtype])


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5])
def test_spec_pool_int8_matches_xla(t):
    case = _case(hd=128, t=t, lens=[n + 1 for n in LENS], seed=4)
    jq, _, jtab, jlens, jkc, jvc = _jax(case, jnp.float32)
    q, _, tables, lens, kc, vc = _torch(case, "float32")
    j_pair, pair = _int8_pools(case)
    want = jt.paged_attention_spec_xla(jq, j_pair, 1, jtab, jlens, jkc, jvc)
    got = tpa.paged_attention_spec_pool(q, pair, 1, tables, lens, kc, vc)
    _close(got, want, 2e-2)
    with pytest.raises(TypeError, match="bf16 pool"):
        tpa.paged_attention_spec(q, pair, 1, tables, lens, kc, vc)


def test_fold_chunk_round_trip_and_causal_combine():
    """`_unfold_chunk` inverts `_fold_chunk`'s layout, and query i of the
    chunk never sees chunk tokens j > i."""
    rng = np.random.default_rng(8)
    b, t, qh, kh, hd = 2, 4, 8, 2, 16
    q = torch.from_numpy(rng.normal(size=(b, t, qh, hd)).astype(np.float32))
    folded = tpa._fold_chunk(q, kh)
    assert folded.shape == (b, kh * t * (qh // kh), hd)
    acc = folded.reshape(b, kh, t * (qh // kh), hd)
    m = acc[..., 0]
    u_acc, u_m, u_l = tpa._unfold_chunk(acc, m, m, t)
    torch.testing.assert_close(u_acc.reshape(b, t, qh, hd), q)
    torch.testing.assert_close(u_m, u_l)
    kc = torch.from_numpy(rng.normal(size=(b, t, kh, hd)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(b, t, kh, hd)).astype(np.float32))
    zeros = torch.zeros((b, t, kh, qh // kh, hd))
    none = torch.full((b, t, kh, qh // kh), float("-inf"))
    out = tpa._combine_chunk(q, zeros, none, none.exp(), kc, vc)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, -1] += 5.0
    vc2[:, -1] -= 5.0
    out2 = tpa._combine_chunk(q, zeros, none, none.exp(), kc2, vc2)
    torch.testing.assert_close(out[:, :-1], out2[:, :-1])
    assert not torch.allclose(out[:, -1], out2[:, -1])


# -- the wrappers' contract ---------------------------------------------------


def test_cpu_tensors_never_count_a_launch():
    wrappers = (tpa.paged_decode_attention, tpa.paged_decode_attention_partial,
                tpa.paged_decode_attention_pool_folded,
                tpa.paged_decode_attention_pool_int8_folded)
    for fn in wrappers:
        fn.launches = 0
    q, kv, tables, lens, kc, vc = _torch(_case(t=3, lens=[2, 9, 24]),
                                         "bfloat16")
    tpa.paged_attention(q[:, :1], kv, 0, tables, lens[:, None] - 1, lens)
    tpa.paged_attention_decode_fused(q[:, :1], kv, 0, tables, lens,
                                     kc[:, :1], vc[:, :1])
    tpa.paged_attention_spec(q, kv, 0, tables, lens, kc, vc)
    tpa.paged_attention_spec_pool(q, kv, 0, tables, lens, kc, vc)
    assert [fn.launches for fn in wrappers] == [0, 0, 0, 0]


def test_non_cpu_tensors_never_take_the_plain_path():
    """Only tensors on the CPU run the plain versions: anything else either
    launches a kernel (CUDA) or raises."""
    q = torch.empty((2, 8, 64), dtype=torch.bfloat16, device="meta")
    pages = torch.empty((4, 8, 4, 64), dtype=torch.bfloat16, device="meta")
    tables = torch.empty((2, 3), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    for fn in (tpa.paged_decode_attention, tpa.paged_decode_attention_partial):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(q, pages, pages, tables, lens)
    pool = torch.empty((1, 2, 4, 8, 4, 64), dtype=torch.bfloat16,
                       device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.paged_decode_attention_pool_folded(q, pool, 0, tables, lens)


def test_slice_checks_refuse_what_the_kernel_does_not_take():
    """The one-layer kernels read K and V in place: a layer slice of the
    pool passes (strided, not copied), and so does a group of any width (the
    kernel tiles the rows; its accumulators no longer cap g * hd at 3072);
    mismatched strides, a wrong dtype or rows off 16-byte boundaries raise
    before any launch."""
    q, kv, tables, lens, _, _ = _torch(_case(hd=128), "bfloat16")
    name = "paged_decode_attention"
    k, v = kv[1, 0], kv[1, 1]
    out = tpa._check_slice_inputs(name, q[:, 0], k, v, tables, lens)
    assert out[-2:] == (k.stride(0), k.stride(1))
    with pytest.raises(ValueError, match="equal strides"):
        tpa._check_slice_inputs(name, q[:, 0], k, v.contiguous()[:, :, :1]
                                .expand_as(v), tables, lens)
    with pytest.raises(TypeError, match="bf16"):
        tpa._check_slice_inputs(name, q[:, 0], k.float(), v.float(), tables,
                                lens)
    b, kh = q.shape[0], k.shape[2]
    wide = torch.zeros((b, kh * (3072 // 128 + 1), 128), dtype=torch.bfloat16)
    assert tpa._check_slice_inputs(name, wide, k, v, tables, lens)[2] == 25
    assert tpa._check_pool_inputs(name, wide, kv, 0, tables, lens,
                                  torch.bfloat16)[2] == 25
    flat = torch.zeros(k.numel() + 8, dtype=torch.bfloat16)
    shifted = flat[4:4 + k.numel()].view(k.shape)  # starts 8 bytes in
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tpa._check_slice_inputs(name, q[:, 0], shifted, shifted, tables, lens)
    p, ps = k.shape[0], k.shape[1]
    odd = torch.as_strided(torch.zeros(p * (k[0].numel() + 4),
                                       dtype=torch.bfloat16),
                           k.shape, (k[0].numel() + 4, kh * 128, 128, 1))
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tpa._check_slice_inputs(name, q[:, 0], odd, odd, tables, lens)
