"""Weight-only int4 linear layers (W4A16).

Port of `dynamo_tpu/ops/q4_linear.py`. The dense projection stack is stored
as packed 4-bit codes (two per byte) with per-group asymmetric scale and
zero rows (group = `PACK_BLOCK` contracted rows, or `DYNT_Q4_GROUP`),
dequantized as (u - z) * s with s, z constant over each group.

Two pack layouts coexist; the packed dtype says which (uint8 = v1,
int8 = v2), so the version travels with the leaf:

  v1 (half-block, uint8): within each group, byte row r holds code row r in
    its low nibble and code row r + group // 2 in its high nibble.
  v2 (global half split, int8): byte row r of the whole array holds code
    row r (low nibble) and code row r + K // 2 (high nibble), codes biased
    to signed nibbles (c = u - 8). Needs K % (2 * group) == 0; smaller
    weights fall back to v1. Scale and zero rows are identical across the
    layouts, so repacking v1 <-> v2 is a pure transform of the code bytes.

`q4_matmul` dispatches on the dtype to `q4_matmul_v1` / `q4_matmul_v2`,
which launch the two entry points of the hand-written CUDA kernel
`csrc/q4_matmul.cu` for CUDA tensors (nibbles unpack and dequantize on the
SM; no bf16 or int8 copy of the weight exists in HBM), raise on anything
it does not take, and run the plain PyTorch version `q4_matmul_ref` only
for CPU tensors. At M <= 80 the kernel splits K across blocks by
`q4_split_plan` (shapes only); the wrapper allocates the f32 workspace of
the splits' partials. Above 80 rows it runs the prefill body that the W8A16
kernel shares (`prefill_plan`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import env
from . import _build
from ._gemm_plan import SMALL_M, SMS, STAGE_ROWS, SplitPlan, prefill_plan
from ._launch import (
    check_launch,
    count_launch,
    require,
    runs_plain,
    stream_of,
)

# Preferred contracted rows per quantization group; DYNT_Q4_GROUP=128 gives
# finer groups. Small weights fall back to the largest power-of-two divisor
# of K.
PACK_BLOCK = 256

PACK_V1 = 1
PACK_V2 = 2

# Leaf name -> number of LEADING contracted axes.
QUANT_LEAVES = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 2,
    "w_gate": 1, "w_up": 1, "w_down": 1,
    "lm_head": 1,
}

_KERNEL = "q4_matmul"


def pack_version(q4: torch.Tensor) -> int:
    """Layout version of a packed-int4 leaf (dtype-encoded)."""
    return PACK_V2 if q4.dtype == torch.int8 else PACK_V1


def _group_for(k: int) -> int:
    g = int(env("DYNT_Q4_GROUP") or PACK_BLOCK)
    while g > 2 and k % g:
        g //= 2
    if k % g or g < 2:
        raise ValueError(
            f"int4 needs the contracted size to divide a power-of-two group "
            f"(got K={k}); this weight cannot take the W4A16 kernel")
    return g


def resolve_pack_version(k: int, group: Optional[int] = None,
                         strict: bool = True) -> int:
    """Pack layout for a weight with contracted size `k` under the
    DYNT_Q4_VARIANT policy: auto = v2 wherever K divides 2 * group, v1
    otherwise; v1 / v2 force the layout. Forcing v2 on an incompatible K
    raises when `strict` and falls back to v1 otherwise. An unknown mode
    always raises."""
    g = group or _group_for(k)
    mode = env("DYNT_Q4_VARIANT") or "auto"
    if mode not in ("auto", "v1", "v2"):
        raise ValueError(
            f"unknown DYNT_Q4_VARIANT {mode!r} (expected auto|v1|v2)")
    v2_ok = k % (2 * g) == 0
    if mode == "v1":
        return PACK_V1
    if mode == "v2":
        if not v2_ok:
            if strict:
                raise ValueError(
                    f"DYNT_Q4_VARIANT=v2 needs K % (2*group) == 0 (K={k}, "
                    f"group={g}); this weight only supports the v1 "
                    "half-block layout")
            return PACK_V1
        return PACK_V2
    return PACK_V2 if v2_ok else PACK_V1


class Q4Weight(nn.Module):
    """A W4A16 projection leaf (the JAX leaf {"q4", "qs4", "qz4"}): `q4`
    packed [K // 2, *out_axes] (flat [K // 2, N] for wo, whose groups span
    heads), uint8 for v1 and int8 for v2; `qs4`, `qz4` f32 [K // group, N]."""

    def __init__(self, q4: torch.Tensor, qs4: torch.Tensor,
                 qz4: torch.Tensor) -> None:
        super().__init__()
        if q4.dtype not in (torch.uint8, torch.int8):
            raise TypeError(f"Q4Weight takes uint8 (v1) or int8 (v2) packed "
                            f"codes, got {q4.dtype}")
        if qs4.dtype != torch.float32 or qz4.dtype != torch.float32:
            raise TypeError("Q4Weight takes f32 scale and zero rows")
        self.register_buffer("q4", q4)
        self.register_buffer("qs4", qs4)
        self.register_buffer("qz4", qz4)

    @property
    def out_axes(self) -> tuple[int, ...]:
        return tuple(self.q4.shape[1:])

    def leaf(self) -> dict:
        return {"q4": self.q4, "qs4": self.qs4, "qz4": self.qz4}


# -- packing (torch) ---------------------------------------------------------


def _pack_codes(u: torch.Tensor, group: int) -> torch.Tensor:
    """v1: uint8 codes [K, N] in [0, 15] -> packed uint8 [K // 2, N]."""
    k, n = u.shape
    half = group // 2
    blk = u.reshape(k // group, group, n)
    return (blk[:, :half] | (blk[:, half:] << 4)).reshape(k // 2, n)


def _unpack_codes(packed: torch.Tensor, group: int) -> torch.Tensor:
    k2, n = packed.shape
    half = group // 2
    blk = packed.reshape(k2 // half, half, n)
    return torch.cat([blk & 0xF, blk >> 4], dim=1).reshape(k2 * 2, n)


def _pack_codes_v2(u: torch.Tensor) -> torch.Tensor:
    """v2: uint8 codes [K, N] -> packed int8 [K // 2, N]: byte row r holds
    code rows r and r + K // 2 as signed-biased nibbles ((u + 8) & 0xF)."""
    k, _ = u.shape
    half = k // 2
    lo = (u[:half].to(torch.int32) + 8) & 0xF
    hi = (u[half:].to(torch.int32) + 8) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def _unpack_codes_v2(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of _pack_codes_v2 -> unsigned codes [K, N] in [0, 15]."""
    b = packed.view(torch.uint8)
    return torch.cat([(b & 0xF) ^ 8, (b >> 4) ^ 8], dim=0)


def quantize_weight_q4(w: torch.Tensor, n_contract: int,
                       version: Optional[int] = None) -> dict:
    """Asymmetric per-group int4 over the contracted axes, bit for bit what
    the JAX quantizer gives. Returns {"q4": packed uint8 (v1) / int8 (v2),
    "qs4": f32 [K // group, N] (the clamped scale), "qz4": f32 [K // group,
    N] (unclipped zero point)}. q4 keeps the output axes for a single
    contracted axis ([K // 2, *out_axes]); wo flattens to [K // 2, N].
    `version` None follows DYNT_Q4_VARIANT."""
    out_axes = tuple(w.shape[n_contract:])
    k = math.prod(w.shape[:n_contract])
    n = math.prod(out_axes) if out_axes else 1
    group = _group_for(k)
    if version is None:
        version = resolve_pack_version(k, group)
    grp = w.float().reshape(k // group, group, n)
    lo = grp.amin(dim=1)
    hi = grp.amax(dim=1)
    safe = ((hi - lo) / 15.0).clamp_min(1e-12)
    zero = torch.round(-lo / safe)
    codes = torch.clamp(torch.round(grp / safe[:, None, :]) + zero[:, None, :],
                        0.0, 15.0).reshape(k, n).to(torch.uint8)
    del grp
    if version == PACK_V2:
        if k % (2 * group):
            raise ValueError(f"pack layout v2 needs K % (2*group) == 0 "
                             f"(K={k}, group={group})")
        q4 = _pack_codes_v2(codes)
    else:
        q4 = _pack_codes(codes, group)
    if n_contract == 1 and out_axes:
        q4 = q4.reshape((k // 2,) + out_axes)
    return {"q4": q4, "qs4": safe, "qz4": zero}


# -- host-side repack (pure numpy) -------------------------------------------


def _np_unpack_v1(q2: np.ndarray, group: int) -> np.ndarray:
    k2, n = q2.shape
    half = group // 2
    blk = q2.reshape(k2 // half, half, n)
    return np.concatenate([blk & 0xF, blk >> 4], axis=1).reshape(
        k2 * 2, n).astype(np.uint8)


def _np_pack_v1(u: np.ndarray, group: int) -> np.ndarray:
    k, n = u.shape
    half = group // 2
    blk = u.reshape(k // group, group, n)
    return (blk[:, :half] | (blk[:, half:] << 4)).reshape(
        k // 2, n).astype(np.uint8)


def _np_unpack_v2(packed: np.ndarray) -> np.ndarray:
    b = packed.view(np.uint8)
    return np.concatenate([(b & 0xF) ^ 8, (b >> 4) ^ 8],
                          axis=0).astype(np.uint8)


def _np_pack_v2(u: np.ndarray) -> np.ndarray:
    k, _ = u.shape
    half = k // 2
    lo = (u[:half].astype(np.int32) + 8) & 0xF
    hi = (u[half:].astype(np.int32) + 8) & 0xF
    return (lo | (hi << 4)).astype(np.uint8).view(np.int8)


def repack_q4_leaf(leaf: dict, version: Optional[int] = None) -> dict:
    """Layout migration of one quantized leaf ({"q4", "qs4", "qz4"}
    tensors); the code bytes go through numpy on the host and come back to
    the leaf's device. `version` None follows DYNT_Q4_VARIANT (auto keeps
    v1 where v2 is not well-formed). Scale and zero rows pass through
    untouched, so v1 -> v2 -> v1 is bit-exact. Returns the SAME dict when
    no repack is needed."""
    q4 = leaf["q4"]
    cur = pack_version(q4)
    k2 = q4.shape[0]
    k = k2 * 2
    qs4 = leaf["qs4"]
    group = k // qs4.shape[0]
    if version is None:
        version = resolve_pack_version(k, group, strict=False)
    if version == cur:
        return leaf
    q2 = q4.cpu().numpy().reshape(k2, math.prod(q4.shape[1:]))
    if version == PACK_V2:
        if k % (2 * group):
            raise ValueError(f"cannot repack to v2: K % (2*group) != 0 "
                             f"(K={k}, group={group})")
        out = _np_pack_v2(_np_unpack_v1(q2, group))
    else:
        out = _np_pack_v1(_np_unpack_v2(q2), group)
    out = torch.from_numpy(out.reshape(q4.shape)).to(q4.device)
    return {"q4": out, "qs4": qs4, "qz4": leaf["qz4"]}


# -- matmul --------------------------------------------------------------------


def dequantize_q4(q4: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor) -> torch.Tensor:
    """Full-precision reconstruction [K, N] f32 (plain path / tests)."""
    k2 = q4.shape[0]
    n = math.prod(q4.shape[1:])
    group = (k2 * 2) // scale.shape[0]
    q2 = q4.reshape(k2, n)
    if pack_version(q4) == PACK_V2:
        u = _unpack_codes_v2(q2).float()
    else:
        u = _unpack_codes(q2, group).float()
    s = scale.reshape(-1, n).repeat_interleave(group, dim=0)
    z = zero.reshape(-1, n).repeat_interleave(group, dim=0)
    return (u - z) * s


def q4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, either layout: dequantize (u - z) * s in f32,
    cast to x's dtype, multiply with f32 accumulation, cast back.
    Materializes the weight: a correctness path."""
    w = dequantize_q4(q4, scale, zero).to(x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def q4_split_plan(m: int, n: int, k: int, group: int,
                  version: int) -> SplitPlan:
    """The W4A16 kernel's plan, from shapes only (it never reads the card,
    so a CUDA graph can capture it). M > 80 takes the prefill body
    (`prefill_plan`). M <= 80 takes one block over all rows (16, 48 or 80)
    by 64 columns (M <= 16) or 128, and splits K into spans of whole
    quantization groups of both nibble runs -- v1: group / 2 packed rows
    (code rows c and c + group / 2 share a byte), v2: group packed rows
    (c and c + K / 2 share a byte) -- so no split straddles a scale/zero
    row. Splits: as many as bring the grid to 4 blocks per SM at M <= 16
    (4-warp blocks, up to 5 resident) or 2 above (8-warp blocks, 2
    resident), but no more than keep the f32 partials (n_split x M x N x 4
    bytes, written once and read once) at or under twice the packed
    weight's K x N / 2 bytes. Raises ValueError on a geometry the kernel
    does not take."""
    half = group // 2 if version == PACK_V1 else k // 2
    unit = group // 2 if version == PACK_V1 else group
    if (m <= 0 or n <= 0 or n % 16 or k % 64 or group <= 0 or k % group
            or version not in (PACK_V1, PACK_V2) or half % STAGE_ROWS
            or unit % STAGE_ROWS or (k // 2) % unit):
        raise ValueError(
            f"the W4A16 kernel takes N % 16 == 0, K % 64 == 0 and groups of "
            f"at least 64 rows whose runs tile K (M={m}, K={k}, N={n}, "
            f"group={group}, v{version})")
    if m > SMALL_M:
        return prefill_plan(m, n, k // 2)
    block_m = 16 if m <= 16 else (48 if m <= 48 else SMALL_M)
    block_n = 64 if m <= 16 else 128
    tiles = -(-n // block_n)
    units = (k // 2) // unit
    want = max(1, (4 if m <= 16 else 2) * SMS // tiles)
    cap = max(1, k // (4 * m))
    per = -(-units // min(units, want, cap))
    n_split = -(-units // per)
    return SplitPlan(block_m, block_n, n_split, per * unit,
                     (tiles, n_split))


def _kernel_fn(version: int):
    lib = _build.load(_KERNEL)
    fn = lib.q4_matmul_v2_bf16 if version == PACK_V2 else lib.q4_matmul_v1_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _q4_kernel(version: int, x, q4, scale, zero) -> torch.Tensor:
    name = f"q4_matmul_v{version}"
    want = torch.int8 if version == PACK_V2 else torch.uint8
    require(x.dtype == torch.bfloat16 and q4.dtype == want
            and scale.dtype == torch.float32 and zero.dtype == torch.float32,
            name, f"the kernel takes bf16 x, {want} packed codes and f32 "
            f"scale/zero, got {x.dtype}, {q4.dtype}, {scale.dtype}, "
            f"{zero.dtype}", TypeError)
    require(x.dim() == 2 and q4.dim() == 2 and scale.dim() == 2, name,
            "expected x [M, K], q4 [K // 2, N], scale/zero [K // group, N]")
    m, k = x.shape
    n = q4.shape[1]
    require(q4.shape[0] * 2 == k and k % scale.shape[0] == 0
            and scale.shape[1] == n and zero.shape == scale.shape, name,
            f"x {tuple(x.shape)}, q4 {tuple(q4.shape)}, scale "
            f"{tuple(scale.shape)}, zero {tuple(zero.shape)} do not match")
    group = k // scale.shape[0]
    half = group // 2 if version == PACK_V1 else k // 2
    require(n % 16 == 0 and k % 64 == 0 and half % 32 == 0
            and group % 32 == 0, name,
            f"the kernel needs N % 16 == 0, K % 64 == 0 and groups of at "
            f"least 64 rows (K={k}, N={n}, group={group})")
    require(all(t.is_contiguous() for t in (x, q4, scale, zero)), name,
            "the kernel takes contiguous inputs")
    require(all(t.data_ptr() % 16 == 0 for t in (x, q4, scale, zero)), name,
            "the kernel takes 16-byte aligned x, q4, scale and zero")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    try:
        plan = q4_split_plan(m, n, k, group, version)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    part = (torch.empty((plan.n_split, m, n), dtype=torch.float32,
                        device=x.device) if plan.n_split > 1 else None)
    check_launch(name, _kernel_fn(version)(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        m, n, k, group, plan.block_n, plan.n_split, plan.span, stream_of(x)))
    return out


def q4_matmul_v2(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor) -> torch.Tensor:
    """The v2 (int8, global half split) layout: kernel on CUDA tensors,
    `q4_matmul_ref` on CPU tensors."""
    if runs_plain("q4_matmul_v2", (x, q4, scale, zero)):
        return q4_matmul_ref(x, q4, scale, zero)
    out = _q4_kernel(PACK_V2, x, q4, scale, zero)
    count_launch(q4_matmul_v2)
    return out


def q4_matmul_v1(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor) -> torch.Tensor:
    """The v1 (uint8, half-block) layout: kernel on CUDA tensors,
    `q4_matmul_ref` on CPU tensors."""
    if runs_plain("q4_matmul_v1", (x, q4, scale, zero)):
        return q4_matmul_ref(x, q4, scale, zero)
    out = _q4_kernel(PACK_V1, x, q4, scale, zero)
    count_launch(q4_matmul_v1)
    return out


# Kernel launches since the last reset (the plain CPU version never counts).
q4_matmul_v1.launches = 0
q4_matmul_v2.launches = 0


def q4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
              zero: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ packed-int4 [K // 2, N] with per-group scale/zero
    [K // group, N] -> [M, N] in x's dtype; the layout (and so the kernel
    entry point) follows the packed dtype."""
    if pack_version(q4) == PACK_V2:
        return q4_matmul_v2(x, q4, scale, zero)
    return q4_matmul_v1(x, q4, scale, zero)
