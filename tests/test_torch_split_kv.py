"""Split-KV flash decoding in the port (`ops/paged_attention.py`:
`split_plan`, `split_spans`, `_merge_split_partials`) on the CPU.

The CUDA kernel splits each sequence's history over the grid and merges the
splits' partials in a second kernel; it runs only on the card (chip_smoke.py
holds it against its plain version there). Here the plan is checked for
coverage (every history position read by exactly one split, no table entry
past the owned pages, a plan made from shapes alone), and the plan's plain
mirror `_merge_split_partials` is held against the one-pass plain version
(f32, 1e-6: the same terms summed in another order, each split's weights
rescaled once more) and against the JAX whole-pool kernel in interpret mode
(the tolerances of test_torch_paged_attention.py), for bf16 and int8 pools,
zero-length rows, rows shorter than one span and splits with nothing to
read. Last, a folded speculative chunk wider than the kernel's old
accumulators (g' = 40 rows per kv head at head_dim 128).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import transformer as jt
from dynamo_tpu_torch.models import kv_cache_from_numpy
from dynamo_tpu_torch.ops import paged_attention as tpa
from jax_capabilities import requires_pallas_compiler_params

PS, MAX_PAGES, N_PAGES, N_LAYERS = 16, 16, 8 * 16 + 1, 2
# lengths: an inactive slot, one token, one tile short of a span, a whole
# 64-token unit, one past it, mid-table, the full table
LENS = [0, 1, 63, 64, 65, 200, PS * MAX_PAGES]


def _case(qh=8, kh=2, hd=128, t=1, lens=LENS, seed=21):
    rng = np.random.default_rng(seed)
    b = len(lens)
    kv = rng.normal(size=(N_LAYERS, 2, N_PAGES, PS, kh, hd)).astype(np.float32)
    q = rng.normal(size=(b, t, qh, hd)).astype(np.float32)
    kc = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    vc = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    tables = (rng.permutation(N_PAGES - 1)[: b * MAX_PAGES]
              .reshape(b, MAX_PAGES) + 1).astype(np.int32)
    return q, kv, tables, np.asarray(lens, np.int32), kc, vc


def _pools(case, quantized):
    """(JAX pool, port K, port V, port k_scales, port v_scales) at layer 1:
    the f32 pool, or the same pool quantized by JAX's quantize_kv."""
    if not quantized:
        kv = torch.from_numpy(case[1])
        return jnp.asarray(case[1]), kv[1, 0], kv[1, 1], None, None
    j_pair = jt.quantize_kv(jnp.asarray(case[1]))
    values, scales = kv_cache_from_numpy(
        (np.asarray(j_pair[0]), np.asarray(j_pair[1])), device="cpu")
    return (j_pair, values[1, 0], values[1, 1], scales[1, 0], scales[1, 1])


def _plan(span, b, kh, rows):
    """The kernel's own plan, or one with a given span."""
    plan = tpa.split_plan(b, kh, rows, MAX_PAGES, PS)
    if span is None:
        return plan
    n_split = -(-(MAX_PAGES * PS) // span)
    return plan._replace(span=span, n_split=n_split,
                         grid=(n_split,) + plan.grid[1:])


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("batch,kh,rows,max_pages,ps", [
    (8, 8, 4, 128, 16), (16, 8, 4, 128, 16), (8, 8, 20, 128, 16),
    (8, 8, 40, 128, 16), (1, 1, 4, 8, 16), (3, 2, 4, 6, 4),
    (2, 4, 12, 40, 1), (4, 2, 4, 9, 48), (1, 8, 4, 4096, 16)])
def test_plan_tiles_the_table_and_fills_the_card(batch, kh, rows, max_pages,
                                                 ps):
    plan = tpa.split_plan(batch, kh, rows, max_pages, ps)
    unit = np.lcm(tpa.TILE, ps)
    assert plan.span % unit == 0 and plan.span <= tpa.MAX_SPAN
    ctx = max_pages * ps
    # the splits cover the table, and none starts past it
    assert plan.n_split * plan.span >= ctx > (plan.n_split - 1) * plan.span
    assert plan.row_tile in (16, 32)
    assert plan.row_tile * plan.row_tiles >= rows
    assert plan.row_tile * (plan.row_tiles - 1) < rows
    assert plan.grid == (plan.n_split, kh * plan.row_tiles, batch)
    # the span is the page size's alone: the most units in SPAN tokens (at
    # least one), the same in every batch and at every table width, so a
    # sequence's splits never depend on its neighbours; the card fills
    # through batch x kv heads x splits (2,048 blocks at the engine's 16
    # slots, 8 kv heads and 128-page tables)
    assert plan.span == max(1, tpa.SPAN // unit) * unit
    for other_batch, other_pages in ((1, max_pages), (batch + 7, 2 * max_pages)):
        other = tpa.split_plan(other_batch, kh, rows, other_pages, ps)
        assert other.span == plan.span
    engine = tpa.split_plan(16, 8, 4, 128, 16)
    assert np.prod(engine.grid) == 2048


def test_plan_is_made_from_shapes_alone():
    """The plan never sees the lengths: reading them would make the host
    wait for the card and break the pipelined decode."""
    params = list(inspect.signature(tpa.split_plan).parameters)
    assert params == ["batch", "kh", "rows", "max_pages", "ps"]


@pytest.mark.parametrize("max_pages,ps", [(16, 16), (6, 4), (9, 48),
                                          (40, 1)])
def test_spans_cover_each_position_once(max_pages, ps):
    """Each position below ceil(len / ps) * ps (cut to the table) is read
    by exactly one live split; no split reads a table entry past the owned
    pages, so scratch entries beyond them are never read."""
    plan = tpa.split_plan(2, 2, 4, max_pages, ps)
    for length in range(0, max_pages * ps + 2 * ps):
        owned = min(-(-length // ps), max_pages)
        hist = min(length, owned * ps)
        seen = np.zeros(max_pages * ps, np.int32)
        last = -1
        for start, end in tpa.split_spans(plan, length, ps, max_pages):
            assert start % plan.span == 0 and start > last
            last = start
            assert start < end <= start + plan.span
            seen[start:end] += 1
            assert start // ps >= 0 and -(-end // ps) <= owned
        assert np.all(seen[:hist] == 1) and np.all(seen[hist:] == 0)


# -- the merge, against the one-pass plain version ------------------------------


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("span", [64, 128, 256, None])
def test_merged_partials_match_one_pass(quantized, span):
    case = _case()
    _, k, v, ks, vs = _pools(case, quantized)
    q = torch.from_numpy(case[0][:, 0])
    tables, lens = torch.from_numpy(case[2]), torch.from_numpy(case[3])
    plan = _plan(span, q.shape[0], k.shape[2], q.shape[1] // k.shape[2])
    acc, m, l = tpa._merge_split_partials(q, k, v, tables, lens, plan, ks, vs)
    r_acc, r_m, r_l = tpa._partials_ref(q, k, v, tables, lens, ks, vs)
    empty = lens == 0
    assert torch.all(torch.isneginf(m[empty])) and torch.all(l[empty] == 0)
    assert torch.all(acc[empty] == 0)
    live = ~empty
    torch.testing.assert_close(m[live], r_m[live], rtol=0, atol=0)
    torch.testing.assert_close(l[live], r_l[live], rtol=1e-6, atol=0)
    torch.testing.assert_close(acc[live] / l[live][..., None],
                               r_acc[live] / r_l[live][..., None],
                               rtol=1e-6, atol=1e-6)


def test_all_empty_splits_merge_to_exact_empty_rows():
    """Every split of every row empty: exactly acc 0, m -inf, l 0, no NaN."""
    case = _case(lens=[0, 0, 0])
    _, k, v, _, _ = _pools(case, False)
    q = torch.from_numpy(case[0][:, 0])
    plan = _plan(64, 3, 2, 4)
    acc, m, l = tpa._merge_split_partials(
        q, k, v, torch.from_numpy(case[2]), torch.from_numpy(case[3]), plan)
    assert torch.all(torch.isneginf(m)) and torch.all(l == 0)
    assert torch.all(acc == 0)


# -- the merge, against the JAX kernel in interpret mode --------------------------


@requires_pallas_compiler_params
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_partials_match_pallas_interpret(dtype, quantized):
    from dynamo_tpu.ops.paged_attention import paged_decode_attention_pool

    case = _case(seed=22)
    j_pool, k, v, ks, vs = _pools(case, quantized)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_scales = j_pool[1] if quantized else None
    j_values = j_pool[0] if quantized else j_pool.astype(jdt)
    if not quantized:
        k, v = k.to(tdt), v.to(tdt)
    j_acc, j_m, j_l = paged_decode_attention_pool(
        jnp.asarray(case[0][:, 0], jdt), j_values, 1, jnp.asarray(case[2]),
        jnp.asarray(case[3]), kv_scales=j_scales, interpret=True)
    q = torch.from_numpy(case[0][:, 0]).to(tdt)
    lens = torch.from_numpy(case[3])
    # four splits of one 64-token unit each: the kernel's own plan takes
    # this 256-token table in two spans
    plan = _plan(64, q.shape[0], 2, 4)
    assert plan.n_split == 4
    acc, m, l = tpa._merge_split_partials(q, k, v, torch.from_numpy(case[2]),
                                          lens, plan, ks, vs)
    live = (lens > 0).numpy()
    assert torch.all(torch.isneginf(m[~live])) and torch.all(l[~live] == 0)
    np.testing.assert_allclose(m.numpy()[live], np.asarray(j_m)[live],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.numpy()[live], np.asarray(j_l)[live],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), rtol=1e-4,
                               atol=1e-4)


# -- a fold wider than the old accumulators ------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_wide_fold_beyond_the_old_cap(quantized):
    """g = 8 (qh 16, kh 2) at head_dim 128 with a chunk of T = 5: g' = 40
    rows per kv head, g' * hd = 5120 where the kernel's accumulators used to
    stop at 3072. The fold unfolds exactly, the plan takes two 32-row tiles,
    the split-merge mirror equals the one-pass version at that width, and
    the whole-pool spec attention equals JAX's paged_attention_spec_xla."""
    t, qh, kh, hd = 5, 16, 2, 128
    case = _case(qh=qh, kh=kh, hd=hd, t=t, lens=[n + 1 for n in LENS],
                 seed=23)
    q = torch.from_numpy(case[0])
    folded = tpa._fold_chunk(q, kh)
    rows = t * qh // kh
    assert rows * hd == 5120 and folded.shape == (q.shape[0], kh * rows, hd)
    acc_like = folded.reshape(q.shape[0], kh, rows, hd)
    u_acc, u_m, _ = tpa._unfold_chunk(acc_like, acc_like[..., 0],
                                      acc_like[..., 0], t)
    torch.testing.assert_close(u_acc.reshape(q.shape), q, rtol=0, atol=0)
    torch.testing.assert_close(u_m, q.reshape(*q.shape[:2], kh, -1, hd)[..., 0],
                               rtol=0, atol=0)
    plan = tpa.split_plan(q.shape[0], kh, rows, MAX_PAGES, PS)
    assert (plan.row_tile, plan.row_tiles) == (32, 2)

    j_pool, k, v, ks, vs = _pools(case, quantized)
    tables = torch.from_numpy(case[2])
    hist = (torch.from_numpy(case[3]) - 1).clamp_min(0)
    merged = tpa._merge_split_partials(folded, k, v, tables, hist,
                                       _plan(64, q.shape[0], kh, rows), ks, vs)
    one = tpa._partials_ref(folded, k, v, tables, hist, ks, vs)
    live = hist > 0
    torch.testing.assert_close(merged[1][live], one[1][live], rtol=0, atol=0)
    torch.testing.assert_close(merged[0][live] / merged[2][live][..., None],
                               one[0][live] / one[2][live][..., None],
                               rtol=1e-6, atol=1e-6)

    jq, jtab, jlens, jkc, jvc = (jnp.asarray(case[i]) for i in (0, 2, 3, 4, 5))
    want = jt.paged_attention_spec_xla(jq, j_pool, 1, jtab, jlens, jkc, jvc)
    pool = ((kv_cache_from_numpy((np.asarray(j_pool[0]),
                                  np.asarray(j_pool[1])), device="cpu"))
            if quantized else torch.from_numpy(case[1]))
    got = tpa.paged_attention_spec_pool(
        q, pool, 1, tables, torch.from_numpy(case[3]),
        torch.from_numpy(case[4]), torch.from_numpy(case[5]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
