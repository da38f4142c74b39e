"""Gumbel noise for seeded sampling: JAX's threefry draw, bit for bit.

The JAX package samples a slot with
`jax.random.categorical(fold_in(PRNGKey(seed), step), logits)`: Gumbel noise
of mode "low" from threefry2x32 bits, added to the logits, then `argmax`.
`gumbel_noise(seeds, steps, vocab)` returns that noise, [B, vocab] f32, for
every slot at once, so the port's seeded streams are the JAX engine's.

How JAX 0.9 (with `jax_threefry_partitionable`, its default) draws it:

- `PRNGKey(seed)` is the key (0, seed) for a 32-bit seed;
- `fold_in(key, step)` is `threefry2x32(key, (0, step))`, a new key (a, b);
- `random_bits(key, 32, (V,))` hashes the counter pair (0, i) for each
  index i < V and XORs the two output words;
- `uniform(minval=tiny, maxval=1)` puts the top 23 bits in the mantissa of a
  float in [1, 2), subtracts 1, and clamps to `finfo(f32).tiny`;
- `gumbel` is `-log(-log(u))`.

`gumbel_noise_ref` does that with int64 tensor ops masked to 32 bits (the
plain version, and what runs on the CPU). On the card `gumbel_noise` launches
one fused Triton pass (`ops/gumbel_triton.py`): the per-slot key, the
hash, the float conversion and both logs in registers, one f32 store per
element. It replaces no TPU kernel (XLA fuses the draw into the sampling
step there); without it the plain version's ~130 elementwise passes over
[B, V] int64 tensors ran inside every graphed decode step. The pass is
bound by its store, B * V * 4 bytes. Its logs are libdevice's `logf`, the
function `torch.log` calls on the card, so the two versions agree bit for
bit there.
"""

from __future__ import annotations

import torch

from ._launch import count_launch, require, runs_plain

_M32 = 0xFFFFFFFF
# threefry2x32's key-schedule parity constant and rotation schedule
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# finfo(float32).tiny: the uniform's lower bound
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds), as `jax._src.prng` computes it, on int64
    tensors holding uint32 values; every argument broadcasts."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def gumbel_noise_ref(seeds: torch.Tensor, steps: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """The plain version: [B, vocab] f32 noise of slot b's key
    fold_in(PRNGKey(seeds[b]), steps[b])."""
    seeds = seeds.long() & _M32
    steps = steps.long() & _M32
    zero = torch.zeros_like(seeds)
    key0, key1 = threefry2x32(zero, seeds, zero, steps)
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    b0, b1 = threefry2x32(key0[:, None], key1[:, None], 0, idx[None, :])
    bits = b0 ^ b1
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    u = torch.clamp_min(floats + F32_TINY, F32_TINY)
    return -torch.log(-torch.log(u))


def gumbel_noise(seeds: torch.Tensor, steps: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, vocab] f32 Gumbel noise, a pure function of (seed, step, vocab
    index) per element, equal to JAX's draw. The plain version for CPU
    tensors, the Triton pass for CUDA ones."""
    if runs_plain("gumbel_noise", (seeds, steps)):
        return gumbel_noise_ref(seeds, steps, vocab)
    require(seeds.dim() == 1 and steps.shape == seeds.shape, "gumbel_noise",
            f"seeds {tuple(seeds.shape)} and steps {tuple(steps.shape)} "
            "must be one [B] shape")
    from .gumbel_triton import launch

    out = torch.empty(seeds.shape[0], vocab, device=seeds.device,
                      dtype=torch.float32)
    launch(seeds.long().contiguous(), steps.long().contiguous(), out)
    count_launch(gumbel_noise)
    return out


gumbel_noise.launches = 0
