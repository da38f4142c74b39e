"""The W8A16 kernel's split-K plan (dynamo_tpu_torch.ops.q8_linear.
q8_split_plan), the prefill plan the three dequant-GEMM kernels share above
80 rows (_gemm_plan.prefill_plan), and a plain emulation of the split
reduction, against the JAX package's q8_matmul.

The CUDA bodies run only on the card (chip_smoke.py holds them against the
plain version there). Here: the plan, a function of shapes only, covers
every K row exactly once with boundaries on whole ring stages, keeps the
f32 partials within twice the weight's bytes, takes the prefill tile and
one split above M = 80 and one split for a small K, and refuses what the
kernel does not take; and summing per-split f32 partials in plan order,
then the per-column scale, then casting, gives q8_matmul_ref's and JAX's
interpret-mode kernel's result. Tolerance: 1e-5 x max|ref| on f32 inputs
(f32 summation orders), as test_torch_q4_split.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import q8_linear as jq8
from dynamo_tpu_torch.models import get_config
from dynamo_tpu_torch.ops import _gemm_plan as gp
from dynamo_tpu_torch.ops import q4_linear as tq4
from dynamo_tpu_torch.ops import q8_linear as tq8
from jax_capabilities import requires_pallas_compiler_params

REL_TOL = 1e-5
MS = (1, 8, 16, 40, 80, 81, 512, 2048)


def _geometries(name):
    """(K, N) of a preset's projections: wq, wk/wv, wo, gate/up, down,
    lm_head."""
    c = get_config(name)
    q, kv = c.n_q_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return sorted({(c.hidden, q), (c.hidden, kv), (q, c.hidden),
                   (c.hidden, c.mlp_hidden), (c.mlp_hidden, c.hidden),
                   (c.hidden, c.vocab_size)})


CASES = _geometries("mistral-7b") + _geometries("tiny-test")


def _spans(plan, k):
    """The [start, end) code rows each split contracts, in split order (the
    order the kernel's reduction adds the partials in)."""
    return [(s * plan.span, min((s + 1) * plan.span, k))
            for s in range(plan.n_split)]


def test_geometries_are_the_presets():
    assert len(_geometries("mistral-7b")) == 5
    assert (14336, 4096) in CASES and (64, 32) in CASES


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", CASES)
def test_splits_cover_every_row_once_on_stage_boundaries(k, n, m):
    plan = tq8.q8_split_plan(m, n, k)
    spans = _spans(plan, k)
    assert len(spans) == plan.n_split >= 1
    covered = np.zeros(k, np.int64)
    for a, b in spans:
        assert a < b and a % gp.STAGE_ROWS == 0
        assert (b - a) % gp.STAGE_ROWS == 0
        covered[a:b] += 1
    np.testing.assert_array_equal(covered, np.ones(k, np.int64))
    if m <= gp.SMALL_M:
        assert plan.grid == (-(-n // plan.block_n), plan.n_split)
        assert plan.block_m >= m and plan.block_m % 16 == 0
        assert plan.block_n == (128 if m <= 16 else 256)
        # the f32 partials are at most twice the weight's bytes
        assert plan.n_split == 1 or plan.n_split * m * n * 4 <= 2 * k * n


@pytest.mark.parametrize("m", [81, 128, 129, 200, 512, 1500, 2048])
@pytest.mark.parametrize("k,n", CASES)
def test_prefill_plan_above_80_rows_for_every_mode(k, n, m):
    """Every mode takes the shared prefill body above 80 rows: its tile, one
    split over all the contracted rows (q4: the packed rows)."""
    bm, bn = gp.PREFILL_TILE
    want_grid = (-(-n // bn), -(-m // bm))
    plans = [(tq8.q8_split_plan(m, n, k), k)]
    for version in (tq4.PACK_V1, tq4.PACK_V2):
        group = 256
        while k % group:
            group //= 2
        if group >= 64 and (version == tq4.PACK_V1 or k % (2 * group) == 0):
            plans.append((tq4.q4_split_plan(m, n, k, group, version), k // 2))
    for plan, rows in plans:
        assert plan == gp.prefill_plan(m, n, rows)
        assert (plan.block_m, plan.block_n) == (bm, bn)
        assert plan.n_split == 1 and plan.span == rows
        assert plan.grid == want_grid


@pytest.mark.parametrize("m", [1, 16, 40, 80])
@pytest.mark.parametrize("n", [64, 4096])
def test_small_k_takes_one_split(n, m):
    # a split spans at least two ring stages: K = 64 is one split
    plan = tq8.q8_split_plan(m, n, 64)
    assert plan.n_split == 1 and plan.span == 64


# The plans at mistral-7b's geometries: (K, N) -> (block_n, n_split) at the
# runner's decode batch (M = 8 and 16) and verification chunks (M = 40 and
# 80).
PINNED = {
    8: {(4096, 4096): (128, 16), (4096, 1024): (128, 64),
        (4096, 14336): (128, 4), (14336, 4096): (128, 16),
        (4096, 32768): (128, 2)},
    16: {(4096, 4096): (128, 16), (4096, 1024): (128, 64),
         (4096, 14336): (128, 4), (14336, 4096): (128, 16),
         (4096, 32768): (128, 2)},
    40: {(4096, 4096): (256, 16), (4096, 1024): (256, 43),
         (4096, 14336): (256, 4), (14336, 4096): (256, 16),
         (4096, 32768): (256, 2)},
    80: {(4096, 4096): (256, 16), (4096, 1024): (256, 22),
         (4096, 14336): (256, 4), (14336, 4096): (256, 16),
         (4096, 32768): (256, 2)},
}


@pytest.mark.parametrize("m", sorted(PINNED))
def test_plan_at_mistral_decode_and_verification(m):
    for (k, n), (bn, n_split) in PINNED[m].items():
        plan = tq8.q8_split_plan(m, n, k)
        assert (plan.block_n, plan.n_split) == (bn, n_split), (k, n)


@pytest.mark.parametrize("m,n,k", [
    (8, 1000, 4096),   # N % 16
    (8, 1024, 4000),   # K % 64
    (8, 1024, 32),     # K below one 64-row step
    (0, 1024, 4096),
    (512, 1008, 96),   # K % 64, prefill
])
def test_plan_refuses_what_the_kernel_does_not_take(m, n, k):
    with pytest.raises(ValueError):
        tq8.q8_split_plan(m, n, k)


def _split_emulation(x, wq, scale):
    """The kernel's arithmetic on the CPU: per split, the f32 product of x's
    columns with the split's code rows, summed in plan order, then the
    per-column scale (the epilogue with one split, the reduction with
    several), then the cast."""
    m, k = x.shape
    plan = tq8.q8_split_plan(m, wq.shape[1], k)
    acc = torch.zeros((m, wq.shape[1]), dtype=torch.float32)
    for a, b in _spans(plan, k):
        acc = acc + x.float()[:, a:b] @ wq.float()[a:b]
    return plan, (acc * scale.float()).to(x.dtype)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@requires_pallas_compiler_params
@pytest.mark.parametrize("m", [3, 40, 80, 81, 200])
def test_split_reduction_matches_ref_and_pallas_interpret(m):
    k, n = 2048, 128
    rng = np.random.default_rng(17 + m)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    leaf = jq8.quantize_weight(jnp.asarray(w), 1)
    wq = torch.from_numpy(np.array(leaf["q8"]))
    scale = torch.from_numpy(np.array(leaf["qs"]))
    plan, got = _split_emulation(torch.from_numpy(x), wq, scale)
    # M <= 80 exercises the split reduction; above, one split (prefill)
    assert (plan.n_split > 1) == (m <= gp.SMALL_M)
    ref = tq8.q8_matmul_ref(torch.from_numpy(x), wq, scale).numpy()
    pallas = np.asarray(jq8.q8_matmul(jnp.asarray(x), leaf["q8"], leaf["qs"],
                                      interpret=True))
    assert _rel_err(got.numpy(), ref) <= REL_TOL
    assert _rel_err(got.numpy(), pallas) <= REL_TOL
