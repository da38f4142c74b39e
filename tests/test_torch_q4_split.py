"""The W4A16 kernel's split-K plan (dynamo_tpu_torch.ops.q4_linear.
q4_split_plan) and a plain emulation of its split reduction, against the
JAX package's q4_matmul.

The CUDA body runs only on the card (chip_smoke.py holds it against the
plain version there). Here: the plan, a function of shapes only, covers
every packed row exactly once, puts every split boundary on whole
quantization groups of both nibble runs, keeps the prefill tile above
M = 80 and one split for a small K; and summing per-split f32 partials in
plan order, then casting, gives q4_matmul_ref's and JAX's interpret-mode
kernel's result. Tolerance: 1e-5 x max|ref| on f32 inputs (f32 summation
orders), as test_torch_q4_linear.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import q4_linear as jq4
from dynamo_tpu_torch.models import get_config
from dynamo_tpu_torch.ops import _gemm_plan as gp
from dynamo_tpu_torch.ops import q4_linear as tq4
from jax_capabilities import requires_pallas_compiler_params

REL_TOL = 1e-5
MS = (1, 8, 16, 40, 80, 81, 512)
VERSIONS = (tq4.PACK_V1, tq4.PACK_V2)


def _geometries(name):
    """(K, N) of a preset's projections: wq, wk/wv, wo, gate/up, down,
    lm_head."""
    c = get_config(name)
    q, kv = c.n_q_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return sorted({(c.hidden, q), (c.hidden, kv), (q, c.hidden),
                   (c.hidden, c.mlp_hidden), (c.mlp_hidden, c.hidden),
                   (c.hidden, c.vocab_size)})


def _cases():
    """Every (K, N, group, version) the plan must take: mistral-7b's five
    geometries at groups of 256 and 128 in both layouts, and tiny-test's at
    the group the quantizer picks, in the layouts that group allows."""
    cases = [(k, n, g, v) for k, n in _geometries("mistral-7b")
             for g in (256, 128) for v in VERSIONS]
    for k, n in _geometries("tiny-test"):
        g = 256
        while k % g:
            g //= 2
        cases += [(k, n, g, v) for v in VERSIONS
                  if v == tq4.PACK_V1 or k % (2 * g) == 0]
    return cases


CASES = _cases()


def _spans(plan, k):
    """The [start, end) packed rows each split contracts, in split order
    (the order the kernel sums the partials in)."""
    return [(s * plan.span, min((s + 1) * plan.span, k // 2))
            for s in range(plan.n_split)]


def _code_rows(p: np.ndarray, k: int, group: int, version: int):
    """(low-nibble, high-nibble) code rows of packed rows p."""
    half = group // 2 if version == tq4.PACK_V1 else k // 2
    lo = (p // half) * 2 * half + p % half
    return lo, lo + half


def test_mistral_geometries_are_covered():
    assert len(_geometries("mistral-7b")) == 5
    assert (14336, 4096) in _geometries("mistral-7b")


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n,group,version", CASES)
def test_splits_cover_every_packed_row_once(k, n, group, version, m):
    plan = tq4.q4_split_plan(m, n, k, group, version)
    spans = _spans(plan, k)
    assert len(spans) == plan.n_split >= 1
    assert spans[0][0] == 0 and spans[-1][1] == k // 2
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert a < b == c
    assert all(a < b for a, b in spans)
    if m <= tq4.SMALL_M:
        assert plan.grid == (-(-n // plan.block_n), plan.n_split)
        assert plan.block_m >= m and plan.block_m % 16 == 0


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n,group,version", CASES)
def test_split_boundaries_hold_whole_groups(k, n, group, version, m):
    """Each split's packed rows hold whole quantization groups of code rows
    (both nibbles), and every ring stage's two runs stay in one group."""
    plan = tq4.q4_split_plan(m, n, k, group, version)
    covered = np.zeros(k, np.int64)
    for a, b in _spans(plan, k):
        lo, hi = _code_rows(np.arange(a, b), k, group, version)
        rows = np.concatenate([lo, hi])
        covered[rows] += 1
        groups = np.unique(rows // group)
        assert len(rows) == len(groups) * group  # no group cut by the split
        for p0 in range(a, b, tq4.STAGE_ROWS):
            s_lo, s_hi = _code_rows(np.arange(p0, p0 + tq4.STAGE_ROWS), k,
                                    group, version)
            assert len(np.unique(s_lo // group)) == 1
            assert len(np.unique(s_hi // group)) == 1
            assert np.all(np.diff(s_lo) == 1) and np.all(np.diff(s_hi) == 1)
    np.testing.assert_array_equal(covered, np.ones(k, np.int64))


@pytest.mark.parametrize("k,n,group,version", CASES)
def test_prefill_tile_above_80_rows(k, n, group, version):
    for m in (81, 512):
        plan = tq4.q4_split_plan(m, n, k, group, version)
        assert (plan.block_m, plan.block_n) == gp.PREFILL_TILE
        assert plan.n_split == 1 and plan.span == k // 2
        bm, bn = gp.PREFILL_TILE
        assert plan.grid == (-(-n // bn), -(-m // bm))


@pytest.mark.parametrize("version", VERSIONS)
def test_small_k_takes_one_split(version):
    # one group's worth of packed rows per layout: nothing to split
    k = 128 if version == tq4.PACK_V1 else 256
    for m in (1, 16, 80):
        plan = tq4.q4_split_plan(m, 4096, k, 128, version)
        assert plan.n_split == 1 and plan.span == k // 2


# The plans at mistral-7b's geometries, group 256, v2 (the engine_q path):
# (K, N) -> (block_n, n_split) at M = 8 and at M = 80.
PINNED = {
    8: {(4096, 4096): (64, 8), (4096, 1024): (64, 8), (4096, 14336): (64, 2),
        (14336, 4096): (64, 7), (4096, 32768): (64, 1)},
    80: {(4096, 4096): (128, 8), (4096, 1024): (128, 8),
         (4096, 14336): (128, 2), (14336, 4096): (128, 7),
         (4096, 32768): (128, 1)},
}


@pytest.mark.parametrize("m", sorted(PINNED))
def test_plan_at_mistral_decode_and_verification(m):
    for (k, n), (bn, n_split) in PINNED[m].items():
        plan = tq4.q4_split_plan(m, n, k, 256, tq4.PACK_V2)
        assert (plan.block_n, plan.n_split) == (bn, n_split), (k, n)
        # the f32 partials are at most twice the packed weight's bytes
        assert plan.n_split == 1 or plan.n_split * m * n * 4 <= k * n


@pytest.mark.parametrize("m,n,k,group,version", [
    (8, 1000, 4096, 256, tq4.PACK_V2),  # N % 16
    (8, 1024, 4000, 256, tq4.PACK_V1),  # K % 64
    (8, 1024, 4096, 32, tq4.PACK_V1),   # a v1 run of 16 rows
    (8, 1024, 4096, 48, tq4.PACK_V2),   # group does not divide K
    (0, 1024, 4096, 256, tq4.PACK_V2),
])
def test_plan_refuses_what_the_kernel_does_not_take(m, n, k, group, version):
    with pytest.raises(ValueError):
        tq4.q4_split_plan(m, n, k, group, version)


def _split_emulation(x, q4, scale, zero):
    """The kernel's arithmetic on the CPU: per split, the f32 product of x's
    columns at the split's code rows with the dequantized weight rows
    (rounded to x's dtype, as the kernel and q4_matmul_ref do), summed in
    plan order, then cast."""
    m, k = x.shape
    n = q4.shape[1]
    group = k // scale.shape[0]
    version = tq4.pack_version(q4)
    plan = tq4.q4_split_plan(m, n, k, group, version)
    w = tq4.dequantize_q4(q4, scale, zero).to(x.dtype).float()
    acc = torch.zeros((m, n), dtype=torch.float32)
    for a, b in _spans(plan, k):
        lo, hi = _code_rows(np.arange(a, b), k, group, version)
        rows = torch.from_numpy(np.concatenate([lo, hi]))
        acc = acc + x.float()[:, rows] @ w[rows]
    return plan, acc.to(x.dtype)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@requires_pallas_compiler_params
@pytest.mark.parametrize("m", [3, 40, 80])
@pytest.mark.parametrize("group", [256, 128])
@pytest.mark.parametrize("version", VERSIONS)
def test_split_reduction_matches_ref_and_pallas_interpret(
        monkeypatch, version, group, m):
    monkeypatch.setenv("DYNT_Q4_GROUP", str(group))
    k, n = 2048, 128
    rng = np.random.default_rng(11 + m)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    leaf = jq4.quantize_weight_q4(jnp.asarray(w), 1, version=version)
    t = {key: torch.from_numpy(np.array(leaf[key]))
         for key in ("q4", "qs4", "qz4")}
    assert t["qs4"].shape[0] == k // group
    plan, got = _split_emulation(torch.from_numpy(x), t["q4"], t["qs4"],
                                 t["qz4"])
    assert plan.n_split > 1  # the reduction is exercised
    ref = tq4.q4_matmul_ref(torch.from_numpy(x), t["q4"], t["qs4"],
                            t["qz4"]).numpy()
    args = [jnp.asarray(x), leaf["q4"], leaf["qs4"], leaf["qz4"]]
    pallas = np.asarray(jq4.q4_matmul(*args, interpret=True))
    assert _rel_err(got.numpy(), ref) <= REL_TOL
    assert _rel_err(got.numpy(), pallas) <= REL_TOL
