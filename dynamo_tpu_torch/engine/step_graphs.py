"""Runner steps as CUDA graphs, one graph per key.

The JAX package never runs a step op by op from Python: `decode`,
`decode_multi` (K steps inside one `lax.scan`), `decode_spec` and each
padded prefill chunk (or batch of chunks) are each one compiled call, cached
per key (`dynamo_tpu/engine/model_runner.py` `_decode_fn` / `_decode_fn_lp`,
`_decode_multi_fns`, `_decode_spec_fns`, `_prefill_fns` by bucket), and the
block table's width is part of every compiled shape. The port's counterpart
is one `StepGraph` per key (`ModelRunner._run_step` builds the key): the
step's closure over static input tensors, captured once as a
`torch.cuda.CUDAGraph`, then replayed after each call's inputs are copied
into the static tensors. Prefill no longer runs eagerly: a chunk is one
replay of its (batch, bucket) key.

Capture, at a key's first use (as `jax.jit` compiles at first call):
  1. the static inputs hold neutral values: every slot inactive (prefill:
     every token invalid), lengths and tables 0, so the step's KV write
     goes to scratch page 0;
  2. the closure runs once eagerly, on the capturing thread and the capture
     stream: that builds the kernels, creates the thread's cuBLAS handle and
     workspace, and runs the kernels' one-time static initializers
     (`cudaFuncSetAttribute`, `cudaGetDriverEntryPoint`) outside the capture;
  3. the same closure is captured into the runner's shared memory pool. A
     capture that fails raises; nothing falls back to eager.

The kernel wrappers count their launches in Python (`.launches`, see
`ops.counted_wrappers`), so a replay cannot move the counts: the capture's
launches are tallied on the capturing thread only (`ops._launch.tally`; the
capture ran nothing, and another runner's thread keeps counting), and every
replay adds them back. The eager run of step 2 did launch its kernels and
adds its counts.

On the CPU (the tests, which ask for `device="cpu"`) there is no graph: a
replay runs the closure on the static inputs directly and copies its results
into the static outputs, under the same counter bookkeeping, so key
selection, the copies in, the clones out and the counts are exercised
without a card.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import counted_wrappers
from ..ops._launch import count_launch, tally
from ..perf.steptrace import LAUNCH_GATE

# A step: static inputs by name -> output tensors.
Step = Callable[[dict], tuple]

NUMPY_DTYPES = {torch.int64: np.int64, torch.int32: np.int32,
                torch.float32: np.float32, torch.bool: np.bool_}


def _by_name(counts: dict) -> dict[str, int]:
    """A tally (wrapper -> launches) by kernel name."""
    return {name: counts[fn] for name, fn in counted_wrappers().items()
            if counts.get(fn)}


def _add_counts(delta: dict[str, int]) -> None:
    wrappers = counted_wrappers()
    for name, n in delta.items():
        count_launch(wrappers[name], n)


def _copy_in(dst: torch.Tensor, value) -> None:
    """Copy a host array or a tensor into static input `dst`. A device
    tensor (the previous block's tokens) is copied on the device. A host
    array goes through a pinned block of PyTorch's caching host allocator,
    which hands the block out again only after this copy has run, so the
    caller may reuse its array at once; a pageable copy would synchronize
    the stream and stall the host on the replay in flight."""
    if isinstance(value, torch.Tensor):
        src = value
    else:
        src = torch.from_numpy(np.ascontiguousarray(
            value, dtype=NUMPY_DTYPES[dst.dtype]))
        if dst.is_cuda:
            src = src.pin_memory()
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"input of shape {tuple(src.shape)} for a static "
                         f"buffer of shape {tuple(dst.shape)}")
    dst.copy_(src, non_blocking=True)


class StepGraph:
    """One key's step: its static inputs, its graph (None on the CPU), its
    static outputs and the kernel launches one replay stands for."""

    def __init__(self, step: Step, inputs: dict[str, torch.Tensor]) -> None:
        self.step = step
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: tuple = ()
        self.launches: dict[str, int] = {}
        self.capture_s = 0.0  # the seconds its capture took

    def capture(self, pool=None, stream: Optional[torch.cuda.Stream] = None
                ) -> None:
        """Steps 2 and 3 of the module docstring; the inputs arrive
        neutral. On the CPU only the eager run happens."""
        with tally() as counts:
            if stream is None:
                # the eager run's outputs become the static ones
                self.outputs = self.step(self.inputs)
            else:
                stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(stream):
                    self.step(self.inputs)
        warm = _by_name(counts)
        _add_counts(warm)  # the eager run launched
        if stream is None:
            self.launches = warm
            return
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with tally() as counts, LAUNCH_GATE.launch():
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = self.step(self.inputs)
        captured = _by_name(counts)
        if captured != warm:
            raise RuntimeError(f"the captured step launched {captured}, its "
                               f"eager run {warm}")
        self.graph, self.outputs, self.launches = graph, outputs, captured

    def run(self, values: dict, clone: bool = True) -> tuple:
        """Copy `values` into the static inputs, replay, and return clones
        of the outputs (a later replay overwrites the static ones). With
        `clone=False` the static outputs themselves: the caller reads or
        indexes them before the key's next replay."""
        for name, value in values.items():
            _copy_in(self.inputs[name], value)
        if self.graph is not None:
            with LAUNCH_GATE.launch():  # never beside a profiler start/stop
                self.graph.replay()
        else:
            with tally():  # stands in for a replay: counted below
                for static, out in zip(self.outputs, self.step(self.inputs)):
                    static.copy_(out)
        _add_counts(self.launches)
        if not clone:
            return self.outputs
        return tuple(out.clone() for out in self.outputs)
