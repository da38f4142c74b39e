"""The tiling the dequant-GEMM kernels share (csrc/dequant_gemm_small_m.cuh,
csrc/dequant_gemm.cuh), for the W8A16 and W4A16 wrappers' plans: the most x
rows the small-M bodies hold, rows per ring stage (packed rows for q4, code
rows for q8), the prefill body's rows and columns, and the SMs of an H100.
"""

from __future__ import annotations

from typing import NamedTuple

SMALL_M = 80
STAGE_ROWS = 32
PREFILL_TILE = (128, 128)
SMS = 132


class SplitPlan(NamedTuple):
    """How one launch of a dequant-GEMM covers [M, N] x its contracted rows
    (q4: K/2 packed rows, q8: K code rows): blocks of `block_m` rows (every
    row at M <= 80) by `block_n` columns, each contracting `span` rows (the
    last split may be shorter); `grid` is the CUDA grid (column tiles,
    n_split) of a small-M body, or (column tiles, row tiles) of the prefill
    body."""
    block_m: int
    block_n: int
    n_split: int
    span: int
    grid: tuple


def prefill_plan(m: int, n: int, rows: int) -> SplitPlan:
    """The prefill body's plan for M > 80 rows of x, every mode: one
    128 x 128 output tile a block, one split over all `rows` contracted
    rows."""
    bm, bn = PREFILL_TILE
    return SplitPlan(bm, bn, 1, rows, (-(-n // bn), -(-m // bm)))
