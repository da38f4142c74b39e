"""What every kernel wrapper checks before and after a launch.

A wrapper runs its plain PyTorch version only when every input lies on the
CPU; otherwise every input must lie on one CUDA device, and the kernel
launches there or the wrapper raises. Nothing falls back.
"""

from __future__ import annotations

import torch


def runs_plain(name: str, tensors) -> bool:
    """True when all `tensors` are CPU tensors (the caller then runs the
    plain version); raises unless they all lie on one CUDA device."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    first = tensors[0].device
    if not all(t.is_cuda and t.device == first for t in tensors):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    return False


def require(ok: bool, name: str, what: str, exc=ValueError) -> None:
    if not ok:
        raise exc(f"{name}: {what}")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the C entry points take
    it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
