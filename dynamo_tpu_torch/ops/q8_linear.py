"""Weight-only int8 linear layers (W8A16).

Port of `dynamo_tpu/ops/q8_linear.py`. The dense projection stack is stored
as int8 codes plus one f32 scale per output channel (symmetric absmax over
the contracted axes), which halves the bytes a decode step streams. The
scale has no contracted axis, so it factors out of the contraction:

    x @ dequant(q8, s) == (x @ q8) * s

`q8_matmul` launches the hand-written CUDA kernel `csrc/q8_matmul.cu` for
CUDA tensors; the int8 codes turn into bf16 on the SM and never exist in
bf16 in HBM. At M <= 80 (decode and verification) the small-M body splits K
across blocks by `q8_split_plan` (shapes only) and builds the tensor-core
operands from the codes in registers; the wrapper allocates the f32
workspace of the splits' partials. Above 80 rows (prefill) it runs the
128 x 128 prefill body that the W4A16 kernel shares. It raises on anything
the kernel does not take, and runs the plain PyTorch version
`q8_matmul_ref` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from . import _build
from ._gemm_plan import SMALL_M, SMS, STAGE_ROWS, SplitPlan, prefill_plan
from ._launch import (
    check_launch,
    count_launch,
    require,
    runs_plain,
    stream_of,
)

# Leaf name -> number of LEADING contracted axes (the rest are output axes,
# which carry the per-channel scale).
QUANT_LEAVES = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 2,
    "w_gate": 1, "w_up": 1, "w_down": 1,
    "lm_head": 1,
}

_KERNEL = "q8_matmul"


class Q8Weight(nn.Module):
    """A W8A16 projection leaf: `q8` int8 in the weight's own layout and
    `qs` f32 with the shape of its output axes (the JAX leaf
    {"q8", "qs"})."""

    def __init__(self, q8: torch.Tensor, qs: torch.Tensor) -> None:
        super().__init__()
        if q8.dtype != torch.int8 or qs.dtype != torch.float32:
            raise TypeError(f"Q8Weight takes int8 codes and f32 scales, got "
                            f"{q8.dtype} and {qs.dtype}")
        self.register_buffer("q8", q8)
        self.register_buffer("qs", qs)

    @property
    def out_axes(self) -> tuple[int, ...]:
        return tuple(self.qs.shape)

    def leaf(self) -> dict:
        return {"q8": self.q8, "qs": self.qs}


def quantize_weight(w: torch.Tensor, n_contract: int) -> dict:
    """Symmetric per-output-channel int8: absmax over the `n_contract`
    leading (contracted) axes. Returns {"q8": int8 like w, "qs": f32 scale
    of the output-axes shape}, bit for bit what the JAX quantizer gives."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=tuple(range(n_contract)))
    scale = absmax / 127.0
    safe = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(w32 / safe), -127, 127).to(torch.int8)
    return {"q8": q, "qs": scale}


def quantize_weight_np(w: np.ndarray, n_contract: int) -> dict:
    """Host-side variant (checkpoint loaders that stay in numpy)."""
    w32 = np.asarray(w, np.float32)
    axes = tuple(range(n_contract))
    absmax = np.max(np.abs(w32), axis=axes)
    scale = absmax / np.float32(127.0)
    safe = np.maximum(scale, np.float32(1e-12))
    q = np.clip(np.round(w32 / safe), -127, 127).astype(np.int8)
    return {"q8": q, "qs": scale.astype(np.float32)}


def q8_matmul_ref(x: torch.Tensor, wq: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: contraction in f32 (bf16 x and int8 codes are
    exact in f32, so this is the f32-accumulated product), then the scale,
    then x's dtype. Materializes the converted weight: a correctness path."""
    acc = x.float() @ wq.float()
    return (acc * scale.float()).to(x.dtype)


def q8_split_plan(m: int, n: int, k: int) -> SplitPlan:
    """The W8A16 kernel's plan, from shapes only (it never reads the card,
    so a CUDA graph can capture it). M > 80 takes the prefill body
    (`prefill_plan`). M <= 80 takes one block over all rows (16, 48 or 80)
    by 128 columns (4 warps of 32) at M <= 16 or 256 (8 warps) above, the
    faster of the two there (PERF.md section 6), and splits K into spans
    of at least two whole 32-row ring stages: as many as bring the grid to
    4 blocks per SM at M <= 16 or 2 above, but no more than keep the f32
    partials (n_split x M x N x 4 bytes, written once and read once) at or
    under twice the weight's K x N bytes. Raises ValueError on a geometry
    the kernel does not take."""
    if m <= 0 or n <= 0 or k <= 0 or n % 16 or k % 64:
        raise ValueError(f"the W8A16 kernel takes N % 16 == 0 and "
                         f"K % 64 == 0 (M={m}, K={k}, N={n})")
    if m > SMALL_M:
        return prefill_plan(m, n, k)
    block_m = 16 if m <= 16 else (48 if m <= 48 else SMALL_M)
    block_n = 128 if m <= 16 else 256
    tiles = -(-n // block_n)
    stages = k // STAGE_ROWS
    want = max(1, (4 if m <= 16 else 2) * SMS // tiles)
    cap = max(1, k // (2 * m))
    per = max(2, -(-stages // min(stages, want, cap)))
    n_split = -(-stages // per)
    return SplitPlan(block_m, block_n, n_split, per * STAGE_ROWS,
                     (tiles, n_split))


def _kernel_fn():
    fn = _build.load(_KERNEL).q8_matmul_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def q8_matmul(x: torch.Tensor, wq: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ wq [K, N] int8 with per-column scale [N] f32 -> [M, N] in
    x's dtype. CUDA tensors launch the kernel (bf16 x; N % 16 == 0 and
    K % 64 == 0, as every dense projection of the supported models has);
    CPU tensors run `q8_matmul_ref`."""
    name = "q8_matmul"
    if runs_plain(name, (x, wq, scale)):
        return q8_matmul_ref(x, wq, scale)
    require(x.dtype == torch.bfloat16 and wq.dtype == torch.int8
            and scale.dtype == torch.float32, name,
            f"the kernel takes bf16 x, int8 codes and f32 scales, got "
            f"{x.dtype}, {wq.dtype}, {scale.dtype}", TypeError)
    require(x.dim() == 2 and wq.dim() == 2 and scale.dim() == 1, name,
            "expected x [M, K], wq [K, N], scale [N]")
    m, k = x.shape
    n = wq.shape[1]
    require(wq.shape[0] == k and scale.shape[0] == n, name,
            f"x {tuple(x.shape)}, wq {tuple(wq.shape)}, scale "
            f"{tuple(scale.shape)} do not match")
    require(n % 16 == 0 and k % 64 == 0, name,
            f"the kernel needs N % 16 == 0 and K % 64 == 0 (K={k}, N={n})")
    require(x.is_contiguous() and wq.is_contiguous() and scale.is_contiguous(),
            name, "the kernel takes contiguous inputs")
    require(all(t.data_ptr() % 16 == 0 for t in (x, wq, scale)), name,
            "the kernel takes 16-byte aligned x, wq and scale")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    try:
        plan = q8_split_plan(m, n, k)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    part = (torch.empty((plan.n_split, m, n), dtype=torch.float32,
                        device=x.device) if plan.n_split > 1 else None)
    check_launch(name, _kernel_fn()(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        m, n, k, plan.block_n, plan.n_split, plan.span, stream_of(x)))
    count_launch(q8_matmul)
    return out


# Kernel launches since the last reset (the plain CPU version never counts).
q8_matmul.launches = 0
