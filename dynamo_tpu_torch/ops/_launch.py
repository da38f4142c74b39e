"""What every kernel wrapper checks before and after a launch.

A wrapper runs its plain PyTorch version only when every input lies on the
CPU; otherwise every input must lie on one CUDA device, and the kernel
launches there or the wrapper raises. Nothing falls back.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# Every wrapper's `.launches` moves under this lock: two workers' scheduler
# threads can launch (and replay graphs) at once, and `+=` on an attribute
# is a read, an add and a write.
COUNT_LOCK = threading.Lock()
_THREAD = threading.local()


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


def count_launch(wrapper, n: int = 1) -> None:
    """Add `n` to `wrapper.launches`, atomically; inside `tally()` on this
    thread, to the tally instead."""
    tally = getattr(_THREAD, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + n
        return
    with COUNT_LOCK:
        wrapper.launches += n


@contextlib.contextmanager
def tally():
    """Count this thread's launches into the yielded dict (wrapper -> n)
    and leave `.launches` alone: what a graph capture launches runs
    nothing, and another thread's launches meanwhile still count."""
    saved = getattr(_THREAD, "tally", None)
    _THREAD.tally = counts = {}
    try:
        yield counts
    finally:
        _THREAD.tally = saved
