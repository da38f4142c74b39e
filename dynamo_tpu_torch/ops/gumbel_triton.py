"""The Triton pass behind `ops.gumbel.gumbel_noise` on the card.

Imported only by the wrapper when it launches (this module imports
`triton`, which exists only on the card's machine). One program computes
BLOCK noise values of one slot: the slot's key from (seed, step), then the
threefry hash of each index, the float in [tiny, 1) and -log(-log(u)), and
one store. Every step is the plain version's (`ops/gumbel.py`), in uint32
registers.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl
from triton.language.extra import libdevice

BLOCK = 1024


@triton.jit
def _rounds(x0, x1, r0: tl.constexpr, r1: tl.constexpr, r2: tl.constexpr,
            r3: tl.constexpr):
    x0 = x0 + x1
    x1 = ((x1 << r0) | (x1 >> (32 - r0))) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << r1) | (x1 >> (32 - r1))) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << r2) | (x1 >> (32 - r2))) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << r3) | (x1 >> (32 - r3))) ^ x0
    return x0, x1


@triton.jit
def _threefry2x32(k0, k1, x0, x1):
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = x0 + k0
    x1 = x1 + k1
    x0, x1 = _rounds(x0, x1, 13, 15, 26, 6)
    x0 = x0 + k1
    x1 = x1 + k2 + 1
    x0, x1 = _rounds(x0, x1, 17, 29, 16, 24)
    x0 = x0 + k2
    x1 = x1 + k0 + 2
    x0, x1 = _rounds(x0, x1, 13, 15, 26, 6)
    x0 = x0 + k0
    x1 = x1 + k1 + 3
    x0, x1 = _rounds(x0, x1, 17, 29, 16, 24)
    x0 = x0 + k1
    x1 = x1 + k2 + 4
    x0, x1 = _rounds(x0, x1, 13, 15, 26, 6)
    x0 = x0 + k2
    x1 = x1 + k0 + 5
    return x0, x1


@triton.jit
def _gumbel_kernel(seeds_ptr, steps_ptr, out_ptr, vocab, tiny,
                   BLOCK_V: tl.constexpr):
    row = tl.program_id(0)
    offs = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
    seed = (tl.load(seeds_ptr + row) & 0xFFFFFFFF).to(tl.uint32)
    step = (tl.load(steps_ptr + row) & 0xFFFFFFFF).to(tl.uint32)
    zero = seed * 0
    # fold_in(PRNGKey(seed), step): PRNGKey(seed) = (0, seed)
    key0, key1 = _threefry2x32(zero, seed, zero, step)
    idx = offs.to(tl.uint32)
    b0, b1 = _threefry2x32(key0, key1, idx * 0, idx)
    bits = b0 ^ b1
    f = ((bits >> 9) | 0x3F800000).to(tl.float32, bitcast=True) - 1.0
    u = tl.maximum(f + tiny, tiny)
    noise = -libdevice.log(-libdevice.log(u))
    tl.store(out_ptr + row.to(tl.int64) * vocab + offs, noise,
             mask=offs < vocab)


def launch(seeds: torch.Tensor, steps: torch.Tensor,
           out: torch.Tensor) -> None:
    """seeds, steps: [B] int64 on the card; out: [B, V] f32, written."""
    b, vocab = out.shape
    grid = (b, triton.cdiv(vocab, BLOCK))
    _gumbel_kernel[grid](seeds, steps, out, vocab,
                         torch.finfo(torch.float32).tiny, BLOCK_V=BLOCK,
                         num_warps=4)
